"""The reference's own scene: an OBJ + MTL file read into plain tensors.

Nothing here comes from the program under test. The file is read as the
renderer's semantics define a scene:

- every ``f`` line is fan-triangulated, in file order, and a triangle's
  index is its place in that order (ties between equal hits go to the
  lowest index);
- a material's BSDF follows its name: "Refractive" refracts, "Metallic"
  is a GGX conductor, anything else is diffuse; ``Kd``, ``Ke``, ``Ni`` and
  ``Pr`` set diffuse colour, emission, index of refraction and roughness
  (defaults 0.8 grey, black, 1.0 and 0.5);
- the area light is the emissive two-triangle quad: its lowest-numbered
  vertex is the corner, the vertex farthest from it the opposite corner,
  the other two (in vertex order) span v1 and v2, and the normal
  ``v1 x v2`` is turned toward the centroid of all vertices;
- the geometric normal of a triangle is ``normalize((v1 - v0) x (v2 - v0))``.

Vertices, edges, normals and the light are float32, built on the host
with numpy's float32 arithmetic. For speed the triangles are also put in
clusters of ``CLUSTER`` along a Morton curve, each with a box grown by a
margin that no rounding of a hit can cross: the boxes only cull
(ray, cluster) pairs that cannot hit, so they change no result.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

DIFFUSE, METALLIC, REFRACTIVE = 0, 1, 2
CLUSTER = 64


def bsdf_of(name: str) -> int:
    if "Refractive" in name:
        return REFRACTIVE
    if "Metallic" in name:
        return METALLIC
    return DIFFUSE


def _read_mtl(path: str) -> dict:
    mats, cur = {}, None
    if not os.path.exists(path):
        return mats
    with open(path) as f:
        for line in f:
            p = line.split()
            if not p or p[0].startswith("#"):
                continue
            if p[0] == "newmtl":
                cur = " ".join(p[1:])
                mats[cur] = dict(diffuse=(0.8, 0.8, 0.8), emission=(0.0, 0.0, 0.0),
                                 roughness=0.5, ior=1.0)
            elif cur is None:
                continue
            elif p[0] == "Kd":
                mats[cur]["diffuse"] = tuple(float(x) for x in p[1:4])
            elif p[0] == "Ke":
                mats[cur]["emission"] = tuple(float(x) for x in p[1:4])
            elif p[0] == "Ni":
                mats[cur]["ior"] = float(p[1])
            elif p[0] == "Pr":
                mats[cur]["roughness"] = float(p[1])
    return mats


def read_obj(path: str):
    """(vertices [V, 3] f32, triangles [T, 3] i64, material of each
    triangle [T] i64, materials: list of (name, properties))."""
    verts, tris, tri_mat = [], [], []
    names: list[str] = []
    props: dict = {}
    cur = -1
    base = os.path.dirname(os.path.abspath(path))
    with open(path) as f:
        for line in f:
            p = line.split()
            if not p or p[0].startswith("#"):
                continue
            if p[0] == "v":
                verts.append((float(p[1]), float(p[2]), float(p[3])))
            elif p[0] == "f":
                ids = []
                for tok in p[1:]:
                    i = int(tok.split("/")[0])
                    ids.append(i - 1 if i > 0 else len(verts) + i)
                for k in range(1, len(ids) - 1):
                    tris.append((ids[0], ids[k], ids[k + 1]))
                    tri_mat.append(cur)
            elif p[0] == "usemtl":
                name = " ".join(p[1:])
                if name not in names:
                    names.append(name)
                cur = names.index(name)
            elif p[0] == "mtllib":
                for name, pr in _read_mtl(os.path.join(base, " ".join(p[1:]))).items():
                    props[name] = pr
                    if name not in names:
                        names.append(name)
    default = dict(diffuse=(0.8, 0.8, 0.8), emission=(0.0, 0.0, 0.0),
                   roughness=0.5, ior=1.0)
    if not names:
        names = ["default"]
    materials = [(n, props.get(n, default)) for n in names]
    mat = np.clip(np.asarray(tri_mat, np.int64), 0, len(names) - 1)
    return (np.asarray(verts, np.float32).reshape(-1, 3),
            np.asarray(tris, np.int64).reshape(-1, 3), mat, materials)


def _unit(v: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(v, axis=-1, keepdims=True)
    return np.where(n > 0, v / np.maximum(n, np.float32(1e-30)), 0.0).astype(np.float32)


def _light(verts, tris, tri_mat, materials):
    emissive = [i for i, (_, pr) in enumerate(materials)
                if float(np.linalg.norm(pr["emission"])) > 0.0]
    quad = tris[np.isin(tri_mat, emissive)]
    ids = np.unique(quad.reshape(-1))
    if quad.shape[0] != 2 or ids.shape[0] != 4:
        raise ValueError("the scene's emission is not one two-triangle quad")
    pts = verts[ids]
    c = pts[0]
    far = 1 + int(np.argmax(np.linalg.norm(pts[1:] - c, axis=1)))
    a, b = (pts[i] - c for i in range(1, 4) if i != far)
    n = np.cross(a, b)
    n = n / np.linalg.norm(n)
    if float(np.dot(n, verts.mean(axis=0) - (c + 0.5 * (a + b)))) < 0.0:
        n = -n
    return dict(corner=c, v1=a, v2=b, normal=n,
                emission=np.asarray(materials[emissive[0]][1]["emission"], np.float32))


def _morton_order(centroids: np.ndarray) -> np.ndarray:
    lo, hi = centroids.min(0), centroids.max(0)
    q = ((centroids - lo) / np.maximum(hi - lo, 1e-30) * 1023).astype(np.int64)

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        return (x | (x << 2)) & 0x09249249
    code = spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)
    return np.argsort(code, kind="stable")


@dataclasses.dataclass
class RefScene:
    v0: torch.Tensor          # [T, 3]
    e1: torch.Tensor
    e2: torch.Tensor
    normal: torch.Tensor
    tri_mat: torch.Tensor     # [T] i64
    occludes: torch.Tensor    # [T] bool: not refractive
    diffuse: torch.Tensor     # [M, 3]
    emission: torch.Tensor    # [M, 3]
    roughness: torch.Tensor   # [M]
    ior: torch.Tensor         # [M]
    bsdf: torch.Tensor        # [M] i64
    emissive: torch.Tensor    # [M] bool
    light: dict               # corner, v1, v2, normal, emission: [3]
    cluster_tris: torch.Tensor  # [C, CLUSTER] i64, -1 past the end
    box_lo: torch.Tensor      # [C, 3] f32, grown by the margin
    box_hi: torch.Tensor

    @property
    def num_tris(self) -> int:
        return self.v0.shape[0]


def load(path: str, device, dtype=torch.float32) -> RefScene:
    """The scene of ``path`` on ``device``, its geometry and shading
    values in ``dtype`` (the boxes stay float32: they only cull)."""
    verts, tris, tri_mat, materials = read_obj(path)
    v0 = verts[tris[:, 0]]
    e1 = verts[tris[:, 1]] - v0
    e2 = verts[tris[:, 2]] - v0
    normal = _unit(np.cross(e1, e2))
    light = _light(verts, tris, tri_mat, materials)
    bsdf = np.array([bsdf_of(n) for n, _ in materials], np.int64)

    # Clusters: boxes in float64, grown by a thousandth of the scene's
    # diagonal, far beyond any float32 rounding of a hit point.
    pts = verts.astype(np.float64)
    order = _morton_order(pts[tris].mean(axis=1))
    n_cl = -(-len(order) // CLUSTER)
    members = np.full(n_cl * CLUSTER, -1, np.int64)
    members[:len(order)] = order
    members = members.reshape(n_cl, CLUSTER)
    corners = pts[tris]                                     # [T, 3, 3]
    lo = np.full((n_cl, 3), np.inf)
    hi = np.full((n_cl, 3), -np.inf)
    for c in range(n_cl):
        m = members[c][members[c] >= 0]
        lo[c] = corners[m].min(axis=(0, 1))
        hi[c] = corners[m].max(axis=(0, 1))
    margin = 1e-3 * float(np.linalg.norm(pts.max(0) - pts.min(0)))

    def t(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), device=device).to(dt)

    return RefScene(
        v0=t(v0), e1=t(e1), e2=t(e2), normal=t(normal),
        tri_mat=t(tri_mat, torch.int64),
        occludes=t(bsdf[tri_mat] != REFRACTIVE, torch.bool),
        diffuse=t([pr["diffuse"] for _, pr in materials]),
        emission=t([pr["emission"] for _, pr in materials]),
        roughness=t([pr["roughness"] for _, pr in materials]),
        ior=t([pr["ior"] for _, pr in materials]),
        bsdf=t(bsdf, torch.int64),
        emissive=t([float(np.linalg.norm(pr["emission"])) > 0.0
                    for _, pr in materials], torch.bool),
        light={k: t(v) for k, v in light.items()},
        cluster_tris=t(members, torch.int64),
        box_lo=t(lo - margin, torch.float32), box_hi=t(hi + margin, torch.float32))
