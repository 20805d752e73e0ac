"""COLLADA (.dae) import (port of hairpt/scene/collada.py, the same code
on the host with the port's models/shapes.Mesh): the counterpart of the
reference's `mtsimport` converter (src/converter/collada.cpp: COLLADA to
scene XML and mesh files).

Scope mirrors what the reference converter extracts for rendering:
geometry (<library_geometries>/<mesh> with <triangles>/<polylist>
primitives, VERTEX/NORMAL/TEXCOORD inputs), the visual-scene node
hierarchy with its transform stack (<matrix>/<translate>/<rotate>/
<scale>/<lookat>), instance_geometry/instance_node indirection, the
asset up-axis + unit scale, and diffuse material colors from
<library_effects> (the reference maps COLLADA's common profile onto
plugin BSDFs; here everything becomes a diffuse color the scene XML can
override). Cameras map to <sensor type="perspective">.

Two entry points:
  load_collada(path)           → list[ImportedMesh] in world space
  convert(path, out_xml[, obj_dir]) → writes OBJ meshes + a scene XML
                                       loadable by scene.xml_loader

The camera's toWorld is its node's matrix as the JAX package writes it;
a COLLADA camera looks down its node's -z, the scene XML's sensor down
its +z (ROADMAP Queue C).
"""
from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import NamedTuple, Optional

import numpy as np

from ..models.shapes import Mesh


class ImportedMesh(NamedTuple):
    name: str
    mesh: Mesh                      # world-space (node transform applied)
    diffuse: Optional[tuple]        # (r, g, b) from the bound material
    material: Optional[str]         # material symbol/name


class ImportedCamera(NamedTuple):
    name: str
    to_world: np.ndarray            # [4, 4]
    fov_deg: float                  # horizontal fov
    aspect: float


def _strip(tag: str) -> str:
    return tag.rsplit('}', 1)[-1]


def _floats(text) -> np.ndarray:
    if not text or not text.split():
        return np.zeros(0)
    return np.asarray(text.split(), dtype=np.float64)


def _ints(text) -> np.ndarray:
    return np.asarray((text or '').split(), dtype=np.int64) \
        if text and text.split() else np.zeros(0, np.int64)


class _Doc:
    """Id-indexed COLLADA document (namespace-agnostic)."""

    def __init__(self, root):
        self.root = root
        self.by_id = {}
        for el in root.iter():
            i = el.get('id')
            if i is not None:
                self.by_id[i] = el

    def ref(self, url):
        return self.by_id.get((url or '').lstrip('#'))

    def find(self, el, name):
        for ch in el:
            if _strip(ch.tag) == name:
                return ch
        return None

    def findall(self, el, name):
        return [ch for ch in el if _strip(ch.tag) == name]


def _source_array(doc: _Doc, src_el) -> np.ndarray:
    """<source> → [N, stride] float array via its accessor."""
    fa = doc.find(src_el, 'float_array')
    data = _floats(fa.text if fa is not None else '')
    tc = doc.find(src_el, 'technique_common')
    stride = 1
    if tc is not None:
        acc = doc.find(tc, 'accessor')
        if acc is not None:
            stride = int(acc.get('stride', '1'))
    n = len(data) // stride
    return data[:n * stride].reshape(n, stride)


def _node_matrix(doc: _Doc, node) -> np.ndarray:
    """Accumulate the node's transform elements in document order
    (collada.cpp: transforms compose left-to-right onto the CTM)."""
    m = np.eye(4)
    for ch in node:
        t = _strip(ch.tag)
        if t == 'matrix':
            m = m @ _floats(ch.text).reshape(4, 4)
        elif t == 'translate':
            v = _floats(ch.text)
            tm = np.eye(4)
            tm[:3, 3] = v[:3]
            m = m @ tm
        elif t == 'scale':
            v = _floats(ch.text)
            m = m @ np.diag([v[0], v[1], v[2], 1.0])
        elif t == 'rotate':
            v = _floats(ch.text)
            ax = v[:3]
            ln = np.linalg.norm(ax)
            if ln > 0:
                ax = ax / ln
                th = np.deg2rad(v[3])
                c, s = np.cos(th), np.sin(th)
                x, y, z = ax
                r = np.array([
                    [c + x * x * (1 - c), x * y * (1 - c) - z * s,
                     x * z * (1 - c) + y * s],
                    [y * x * (1 - c) + z * s, c + y * y * (1 - c),
                     y * z * (1 - c) - x * s],
                    [z * x * (1 - c) - y * s, z * y * (1 - c) + x * s,
                     c + z * z * (1 - c)]])
                rm = np.eye(4)
                rm[:3, :3] = r
                m = m @ rm
        elif t == 'lookat':
            v = _floats(ch.text)
            eye, tgt, up = v[0:3], v[3:6], v[6:9]
            fwd = tgt - eye
            fwd = fwd / np.linalg.norm(fwd)
            right = np.cross(fwd, up / np.linalg.norm(up))
            right = right / np.linalg.norm(right)
            up2 = np.cross(right, fwd)
            lm = np.eye(4)
            lm[:3, 0] = right
            lm[:3, 1] = up2
            lm[:3, 2] = -fwd
            lm[:3, 3] = eye
            m = m @ lm
    return m


def _mesh_from_geometry(doc: _Doc, geom) -> Optional[Mesh]:
    """<geometry>/<mesh> → indexed triangle Mesh (object space)."""
    mesh_el = doc.find(geom, 'mesh')
    if mesh_el is None:
        return None
    # vertices indirection: <vertices id> → POSITION source
    vert_el = doc.find(mesh_el, 'vertices')
    vert_id = vert_el.get('id') if vert_el is not None else None
    pos_src = None
    if vert_el is not None:
        for inp in doc.findall(vert_el, 'input'):
            if inp.get('semantic') == 'POSITION':
                pos_src = doc.ref(inp.get('source'))

    all_pos, all_nrm, all_uv, all_faces = [], [], [], []
    base = 0
    for prim_name in ('triangles', 'polylist', 'polygons'):
        for prim in doc.findall(mesh_el, prim_name):
            inputs = []
            max_off = 0
            for inp in doc.findall(prim, 'input'):
                off = int(inp.get('offset', '0'))
                max_off = max(max_off, off)
                sem = inp.get('semantic')
                src = inp.get('source', '')
                if sem == 'VERTEX' or src.lstrip('#') == vert_id:
                    inputs.append(('VERTEX', off, pos_src))
                else:
                    inputs.append((sem, off, doc.ref(src)))
            stride = max_off + 1
            idx = np.concatenate([
                _ints(p.text) for p in doc.findall(prim, 'p')]) \
                if doc.findall(prim, 'p') else np.zeros(0, np.int64)
            if idx.size == 0:
                continue
            idx = idx.reshape(-1, stride)
            if prim_name == 'polylist':
                vc = _ints(doc.find(prim, 'vcount').text)
            else:
                vc = np.full(idx.shape[0] // 3, 3, np.int64)
            pos_a = _source_array(doc, pos_src) if pos_src is not None \
                else np.zeros((0, 3))
            nrm_a = uv_a = None
            n_off = t_off = None
            v_off = 0
            for sem, off, src in inputs:
                if sem == 'VERTEX':
                    v_off = off
                elif sem == 'NORMAL' and src is not None:
                    nrm_a, n_off = _source_array(doc, src), off
                elif sem == 'TEXCOORD' and src is not None and \
                        t_off is None:
                    uv_a, t_off = _source_array(doc, src), off

            # fan-triangulate each polygon run
            tri_rows = []
            c0 = 0
            for cnt in vc:
                cnt = int(cnt)
                for k in range(1, cnt - 1):
                    tri_rows.append((c0, c0 + k, c0 + k + 1))
                c0 += cnt
            tri_rows = np.asarray(tri_rows, np.int64)   # [F, 3] corner ids
            corn = idx[tri_rows.reshape(-1)]            # [F*3, stride]
            p = pos_a[corn[:, v_off]][:, :3]
            all_pos.append(p)
            all_nrm.append(nrm_a[corn[:, n_off]][:, :3]
                           if nrm_a is not None else None)
            all_uv.append(uv_a[corn[:, t_off]][:, :2]
                          if uv_a is not None else None)
            nf = len(tri_rows)
            all_faces.append(base + np.arange(nf * 3,
                                              dtype=np.int32).reshape(-1, 3))
            base += nf * 3
    if not all_pos:
        return None
    pos = np.concatenate(all_pos)
    nrm = np.concatenate(all_nrm) if all(x is not None for x in all_nrm) \
        else None
    uv = np.concatenate(all_uv) if all(x is not None for x in all_uv) \
        else None
    faces = np.concatenate(all_faces)
    return Mesh(pos, nrm, uv, faces)


def _effect_diffuse(doc: _Doc, mat_el) -> Optional[tuple]:
    """material → effect → common-profile diffuse color."""
    ie = doc.find(mat_el, 'instance_effect')
    eff = doc.ref(ie.get('url')) if ie is not None else None
    if eff is None:
        return None
    for el in eff.iter():
        if _strip(el.tag) == 'diffuse':
            for ch in el:
                if _strip(ch.tag) == 'color':
                    v = _floats(ch.text)
                    return (float(v[0]), float(v[1]), float(v[2]))
    return None


def _asset_transform(doc: _Doc) -> np.ndarray:
    """Up-axis + unit conversion (collada.cpp handles Z_UP/Y_UP/X_UP)."""
    m = np.eye(4)
    asset = doc.find(doc.root, 'asset')
    if asset is None:
        return m
    unit = doc.find(asset, 'unit')
    if unit is not None:
        s = float(unit.get('meter', '1.0'))
        m = np.diag([s, s, s, 1.0]) @ m
    ua = doc.find(asset, 'up_axis')
    up = (ua.text or 'Y_UP').strip() if ua is not None else 'Y_UP'
    if up == 'Z_UP':
        # z-up → y-up: x'=x, y'=z, z'=-y
        m = m @ np.array([[1, 0, 0, 0], [0, 0, 1, 0],
                          [0, -1, 0, 0], [0, 0, 0, 1.0]])
    elif up == 'X_UP':
        m = m @ np.array([[0, 1, 0, 0], [-1, 0, 0, 0],
                          [0, 0, 1, 0], [0, 0, 0, 1.0]])
    return m


def load_collada(path: str):
    """Parse a .dae file → (list[ImportedMesh], list[ImportedCamera]).
    Meshes are in world space (visual-scene node transforms + up-axis/
    unit normalization applied)."""
    doc = _Doc(ET.parse(path).getroot())
    root_m = _asset_transform(doc)
    meshes, cameras = [], []

    def mat_binding(inst_geom):
        """instance_geometry → (diffuse rgb, material name)."""
        for el in inst_geom.iter():
            if _strip(el.tag) == 'instance_material':
                tgt = doc.ref(el.get('target'))
                if tgt is not None:
                    return _effect_diffuse(doc, tgt), \
                        tgt.get('name') or tgt.get('id')
        return None, None

    def walk(node, ctm, depth=0):
        if depth > 32:
            return
        m = ctm @ _node_matrix(doc, node)
        for ch in node:
            t = _strip(ch.tag)
            if t == 'node':
                walk(ch, m, depth + 1)
            elif t == 'instance_node':
                tgt = doc.ref(ch.get('url'))
                if tgt is not None:
                    walk(tgt, m, depth + 1)
            elif t == 'instance_geometry':
                geom = doc.ref(ch.get('url'))
                if geom is None:
                    continue
                mesh = _mesh_from_geometry(doc, geom)
                if mesh is None:
                    continue
                w = m
                pos = mesh.positions @ w[:3, :3].T + w[:3, 3]
                nrm = mesh.normals
                if nrm is not None:
                    it = np.linalg.inv(w[:3, :3]).T
                    nrm = nrm @ it.T
                    nrm = nrm / np.maximum(
                        np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-12)
                diffuse, mat_name = mat_binding(ch)
                meshes.append(ImportedMesh(
                    name=geom.get('name') or geom.get('id') or 'mesh',
                    mesh=Mesh(pos, nrm, mesh.uvs, mesh.faces),
                    diffuse=diffuse, material=mat_name))
            elif t == 'instance_camera':
                cam = doc.ref(ch.get('url'))
                if cam is None:
                    continue
                fov, aspect = 45.0, 1.0
                for el in cam.iter():
                    tg = _strip(el.tag)
                    if tg == 'xfov':
                        fov = float(el.text)
                    elif tg == 'yfov':
                        fov = float(el.text)   # converted below if aspect
                    elif tg == 'aspect_ratio':
                        aspect = float(el.text)
                cameras.append(ImportedCamera(
                    name=cam.get('name') or cam.get('id') or 'camera',
                    to_world=m, fov_deg=fov, aspect=aspect))

    for vs in doc.root.iter():
        if _strip(vs.tag) == 'visual_scene':
            walk(vs, root_m)
            break
    return meshes, cameras


def convert(path: str, out_xml: str, obj_dir: Optional[str] = None):
    """mtsimport parity: COLLADA → per-geometry OBJ files + a scene XML
    that the port's XML loader renders directly. Returns the XML path."""
    meshes, cameras = load_collada(path)
    obj_dir = obj_dir or os.path.dirname(os.path.abspath(out_xml))
    os.makedirs(obj_dir, exist_ok=True)
    lines = ['<scene version="0.5.0">',
             '  <integrator type="path">'
             '<integer name="maxDepth" value="8"/></integrator>']
    if cameras:
        c = cameras[0]
        mtx = ' '.join('%g' % v for v in c.to_world.reshape(-1))
        lines += [
            '  <sensor type="perspective">',
            f'    <float name="fov" value="{c.fov_deg:g}"/>',
            '    <transform name="toWorld">'
            f'<matrix value="{mtx}"/></transform>',
            '    <sampler type="independent">'
            '<integer name="sampleCount" value="16"/></sampler>',
            '    <film type="hdrfilm"><integer name="width" value="512"/>'
            '<integer name="height" value="512"/></film>',
            '  </sensor>']
    for i, im in enumerate(meshes):
        fname = f'{os.path.splitext(os.path.basename(out_xml))[0]}' \
                f'_{i:03d}_{im.name}.obj'
        fpath = os.path.join(obj_dir, fname)
        _write_obj(fpath, im.mesh)
        rgb = im.diffuse or (0.5, 0.5, 0.5)
        lines += [
            '  <shape type="obj">',
            f'    <string name="filename" value="{fname}"/>',
            '    <bsdf type="diffuse"><rgb name="reflectance" '
            f'value="{rgb[0]:g}, {rgb[1]:g}, {rgb[2]:g}"/></bsdf>',
            '  </shape>']
    lines.append('</scene>')
    with open(out_xml, 'w') as f:
        f.write('\n'.join(lines) + '\n')
    return out_xml


def _write_obj(path: str, mesh: Mesh):
    with open(path, 'w') as f:
        for p in mesh.positions:
            f.write('v %g %g %g\n' % (p[0], p[1], p[2]))
        has_n = mesh.normals is not None
        has_t = mesh.uvs is not None
        if has_n:
            for n in mesh.normals:
                f.write('vn %g %g %g\n' % (n[0], n[1], n[2]))
        if has_t:
            for t in mesh.uvs:
                f.write('vt %g %g\n' % (t[0], t[1]))
        for tri in mesh.faces + 1:
            if has_n and has_t:
                f.write('f %d/%d/%d %d/%d/%d %d/%d/%d\n' % (
                    tri[0], tri[0], tri[0], tri[1], tri[1], tri[1],
                    tri[2], tri[2], tri[2]))
            elif has_n:
                f.write('f %d//%d %d//%d %d//%d\n' % (
                    tri[0], tri[0], tri[1], tri[1], tri[2], tri[2]))
            else:
                f.write('f %d %d %d\n' % (tri[0], tri[1], tri[2]))
