"""Port parity for the instanced (two-level) path:
tpu_pt_torch.intersect.instanced (the CPU path of the CUDA kernels K9 and
K10) against tpu_pt.intersect.pallas_inst, run in Pallas interpret mode as
tests/test_instanced.py runs it, on the same numpy inputs.

The fixture is tests/test_instanced.py's: a cube and a tetrahedron
instanced nine times with random rotations, non-uniform scales and one
mirrored instance; here the tetrahedra are glass, so their instances pass
shadow rays.

Tolerances: hit mask, occlusion flags, the instance tables and the mesh
boxes are equal. t agrees to 1e-4 (|t| <= ~20 here; XLA fuses the
transform's and the plane test's multiply-adds, PyTorch rounds each
operation). The winning (instance, row) and its material are equal except
on ties: the JAX kernel keeps the first candidate visited at an equal t,
the port the lowest (instance, row), so a mismatch must be a second
(instance, row) hit at the same t. u/v and the world normal agree to 1e-5
where the winners agree (the same rounding differences).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_pt.intersect import pallas_inst as pi  # noqa: E402
from tpu_pt.scene import arrays as jarrays  # noqa: E402
from tpu_pt.vec3 import V3  # noqa: E402
import tpu_pt_torch as tp  # noqa: E402
from tpu_pt_torch import mathlib as ml  # noqa: E402
from tpu_pt_torch.camera import Camera  # noqa: E402
from tpu_pt_torch.intersect import clustered, dense, instanced  # noqa: E402
from tpu_pt_torch.intersect import moller  # noqa: E402
from tpu_pt_torch.render import CameraArrays  # noqa: E402
from tpu_pt_torch.whitted import render_whitted_wavefront  # noqa: E402
from test_instanced import (_cube, _tetra, _trs,  # noqa: E402
                            _write_gpu_instanced, _write_instanced_city)

T_TOL = 1e-4
ATTR_TOL = 1e-5
MATS = [dict(diffuse=(0.8, 0.2, 0.2), emission=(0, 0, 0), roughness=0.5,
             metallic=0.0, ior=1.5, bsdf=0),
        dict(diffuse=(0.9, 0.9, 0.9), emission=(0, 0, 0), roughness=0.0,
             metallic=0.0, ior=1.5, bsdf=jarrays.BSDF_REFRACTION)]


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a, np.float32))


def _v3(a):
    return V3(*[jnp.asarray(a[:, k], jnp.float32) for k in range(3)])


@pytest.fixture(scope="module")
def fixture():
    """Unique geometry, instance list and flattened geometry (numpy),
    the JAX geom / table and the port's geom / table / flattened scene."""
    rng = np.random.default_rng(7)
    cv, cf = _cube()
    tv, tf = _tetra()
    verts = np.concatenate([cv, tv])
    faces = np.concatenate([cf, tf + len(cv)])
    mat_ids = np.concatenate([np.zeros(len(cf), np.int64),
                              np.ones(len(tf), np.int64)])
    mesh_ranges = [(0, len(cf)), (len(cf), len(cf) + len(tf))]
    mesh_aabbs = [(cv.min(0), cv.max(0)), (tv.min(0), tv.max(0))]
    instances, flat_v, flat_f, flat_m = [], [], [], []
    nv = 0
    for i in range(9):
        slot = i % 2
        if i == 8:                       # mirrored (negative determinant)
            scale = [-1.0, 1.0, 1.0]
        elif i % 3 == 0:
            scale = (0.4 + rng.random(3)).tolist()          # non-uniform
        else:
            scale = [0.5 + 0.5 * rng.random()] * 3
        m = _trs(rng.random(3) * 8 - 4, scale, i % 3, rng.random() * 6)
        instances.append((slot, m))
        mv, mf = (cv, cf) if slot == 0 else (tv, tf)
        flat_v.append(ml.transform_points(m.astype(np.float32), mv))
        flat_f.append(mf + nv)
        nv += len(mv)
        flat_m.append(np.full(len(mf), slot, np.int64))
    flat = (np.concatenate(flat_v), np.concatenate(flat_f),
            np.concatenate(flat_m))
    jgeom = jarrays.build_scene_arrays(verts, faces, mat_ids, MATS)
    jtable = pi.build_instance_table(mesh_ranges, mesh_aabbs, instances)
    geom = tp.scene.build_scene_arrays(verts, faces, mat_ids, MATS,
                                       device="cpu")
    table = instanced.build_instance_table(mesh_ranges, mesh_aabbs, instances)
    fgeom = tp.scene.build_scene_arrays(*flat, MATS, device="cpu")
    return dict(instances=instances, jgeom=jgeom, jtable=jtable, geom=geom,
                table=table, fgeom=fgeom, mesh_ranges=mesh_ranges)


def _aimed_rays(instances, n, seed, dist=12.0):
    """Rays from a shell of radius ``dist`` aimed at random instances."""
    rng = np.random.default_rng(seed)
    targets = np.stack([m[:3, 3] for _, m in instances])
    o = rng.normal(size=(n, 3))
    o = o / np.linalg.norm(o, axis=1, keepdims=True) * dist
    d = targets[rng.integers(0, len(targets), n)] - o \
        + rng.normal(size=(n, 3)) * 0.3
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def test_tables_match_reference(fixture):
    """The instance table (rows, nrm, fwd, world boxes) is bitwise the JAX
    package's; cols 6:8 of the boxes are the port's culling margins. The
    packed mesh table's plane, validity, refractive, material and id
    columns and its cluster boxes are bitwise equal; the edge-function
    columns differ by the rounding of the multiply-adds XLA fuses in
    ``pack_tris`` (a few ulps, as in test_torch_clustered.py)."""
    jt, t = fixture["jtable"], fixture["table"]
    assert t.count == jt.count == 9
    assert t.mesh_ranges == jt.mesh_ranges
    for k in ("rows", "nrm", "fwd"):
        np.testing.assert_array_equal(getattr(t, k).numpy(),
                                      np.asarray(getattr(jt, k)), err_msg=k)
    np.testing.assert_array_equal(t.boxes.numpy()[:, :6],
                                  np.asarray(jt.boxes)[:, :6])
    margins = t.boxes.numpy()[:, 6:8]
    assert (margins[:9] > 0).all() and (margins[9:] == 0).all()
    jtris, jboxes = pi.pack_tris_instanced(fixture["jgeom"], jt.mesh_ranges)
    tris, boxes = instanced.pack_tris_instanced(fixture["geom"],
                                                t.mesh_ranges)
    jtris, jboxes = np.asarray(jtris), np.asarray(jboxes)
    assert tris.shape == jtris.shape == (1024, 16)
    np.testing.assert_array_equal(boxes.numpy(), jboxes)
    ours = tris.numpy()
    for cols in (slice(0, 4), slice(12, 16)):
        np.testing.assert_array_equal(ours[:, cols], jtris[:, cols])
    np.testing.assert_allclose(ours[:, 4:12], jtris[:, 4:12], rtol=1e-5,
                               atol=1e-6)


def _tied(tables, o, d, inst, row, t_ref):
    """t of (instance, row) pairs by the port's own transform and plane
    test, for checking a different winner is a tie."""
    rows = tables.table.rows
    out = []
    for k in range(o.shape[0]):
        om, dm = instanced._xform(rows[inst[k]:inst[k] + 1, 0:12],
                                  o[k:k + 1], d[k:k + 1])
        tk, _, _ = dense._pe_block(om, dm, tables.tris[row[k]:row[k] + 1],
                                   0.01)
        out.append(float(tk[0, 0]))
    return np.abs(np.array(out) - t_ref)


def test_closest_matches_pallas(fixture):
    """K9's plain version through ``closest_hit`` against
    ``pallas_inst.intersect_closest`` on 512 aimed rays."""
    o, d = _aimed_rays(fixture["instances"], 512, seed=3)
    j = pi.intersect_closest(fixture["jgeom"], fixture["jtable"], _v3(o),
                             _v3(d))
    tables = instanced.prepare(fixture["geom"], fixture["table"])
    before = dict(instanced.LAUNCHES)
    h = instanced.closest_hit(tables, _t(o), _t(d))
    assert instanced.LAUNCHES == before      # CPU tensors: plain versions
    hit = np.asarray(j.hit)
    np.testing.assert_array_equal(h.hit.numpy(), hit)
    assert hit.sum() > 200
    jt = np.asarray(j.t)
    np.testing.assert_array_equal(h.t.numpy()[~hit], jt[~hit])
    assert np.abs(h.t.numpy() - jt)[hit].max() <= T_TOL
    same = ((h.inst.numpy() == np.asarray(j.inst))
            & (h.tri.numpy() == np.asarray(j.tri)))
    assert same.mean() >= 0.99
    if not same.all():
        # The JAX winner is hit at the port's t.
        jrow = np.asarray(j.tri)[~same]     # unique tri id == packed row
        gap = _tied(tables, _t(o[~same]), _t(d[~same]),
                    np.asarray(j.inst)[~same], jrow, h.t.numpy()[~same])
        assert (gap <= T_TOL).all(), gap
    np.testing.assert_array_equal(h.mat.numpy()[same],
                                  np.asarray(j.mat)[same])
    for ours, ref in ((h.u, j.u), (h.v, j.v)):
        np.testing.assert_allclose(ours.numpy()[same], np.asarray(ref)[same],
                                   atol=ATTR_TOL)
    jn = np.asarray(j.normal.to_array())
    np.testing.assert_allclose(h.normal.numpy()[same], jn[same],
                               atol=ATTR_TOL)
    # Every instance is hit, the mirrored one included.
    assert set(h.inst.numpy()[hit].tolist()) == set(range(9))


@pytest.mark.parametrize("tmax_v", [4.0, 14.0])
def test_occluded_matches_pallas(fixture, tmax_v):
    """K10's plain version against ``pallas_inst.intersect_occluded``:
    equal flags; the glass tetrahedra pass shadow rays."""
    o, d = _aimed_rays(fixture["instances"], 512, seed=11)
    tmax = np.full(512, tmax_v, np.float32)
    tmax[:16] = 0.0                                # parked shadow rays
    j = np.asarray(pi.intersect_occluded(fixture["jgeom"], fixture["jtable"],
                                         _v3(o), _v3(d), jnp.asarray(tmax)))
    tables = instanced.prepare(fixture["geom"], fixture["table"])
    ours = instanced.occluded_hit(tables, _t(o), _t(d), _t(tmax))
    np.testing.assert_array_equal(ours.numpy(), j)
    assert not ours[:16].any()
    if tmax_v > 10:
        assert 0.2 < j.mean() < 0.9
        # Rays whose closest hit is a glass instance and that hit nothing
        # else are not occluded.
        h = instanced.closest_hit(tables, _t(o), _t(d))
        glass = h.hit & (h.mat == 1)
        assert bool(glass.any()) and not bool(ours[glass].all())


def test_instanced_matches_flattened(fixture):
    """The port's instanced hits against its own flattened scene (brute
    force): the same hits, t, materials, barycentrics and world normals,
    sign included (the mirrored instance)."""
    o, d = _aimed_rays(fixture["instances"], 512, seed=5)
    tables = instanced.prepare(fixture["geom"], fixture["table"])
    hi = instanced.closest_hit(tables, _t(o), _t(d))
    hf = moller.intersect_closest(fixture["fgeom"], _t(o), _t(d))
    m = hi.hit.numpy()
    np.testing.assert_array_equal(m, hf.hit.numpy())
    assert m.sum() > 200
    np.testing.assert_allclose(hi.t.numpy()[m], hf.t.numpy()[m], atol=2e-4)
    np.testing.assert_array_equal(hi.mat.numpy()[m], hf.mat.numpy()[m])
    dots = (hi.normal.numpy()[m] * hf.normal.numpy()[m]).sum(1)
    assert dots.min() > 0.9999
    np.testing.assert_allclose(hi.u.numpy()[m], hf.u.numpy()[m], atol=5e-4)
    np.testing.assert_allclose(hi.v.numpy()[m], hf.v.numpy()[m], atol=5e-4)
    tmax = _t(np.full(512, 14.0, np.float32))
    np.testing.assert_array_equal(
        instanced.occluded_hit(tables, _t(o), _t(d), tmax).numpy(),
        moller.intersect_occluded(fixture["fgeom"], _t(o), _t(d),
                                  tmax).numpy())


def _slab(o, d, lo, hi, m):
    """The kernels' slab test, [R] rays x [B] boxes grown by m [R, B]."""
    g = torch.where(d.abs() > 1e-12, d,
                    torch.where(d >= 0, 1e-12, -1e-12).to(d.dtype))
    inv = (1.0 / g)[:, None]
    t0 = (lo[None] - m[..., None] - o[:, None]) * inv
    t1 = (hi[None] + m[..., None] - o[:, None]) * inv
    return torch.minimum(t0, t1).amax(2), torch.maximum(t0, t1).amin(2)


@pytest.mark.parametrize("camera", ["near", "far"])
def test_culling_boxes_are_conservative(fixture, camera):
    """Every (ray, instance, row) the plane + edge test accepts lies in
    the slab interval of its instance's world box grown by a * max|o| + b
    and of its cluster's mesh-space box grown by the mesh margin, which
    is what makes the kernels' two culls exact. The instances have
    non-uniform scales and a mirror; ``far`` looks at the scene from
    10^5 times its size."""
    dist = 12.0 if camera == "near" else 1.2e6
    o, d = _aimed_rays(fixture["instances"], 512, seed=17, dist=dist)
    o, d = _t(o), _t(d)
    tables = instanced.prepare(fixture["geom"], fixture["table"])
    table, cl = tables.table, clustered.CLUSTER
    wb = table.boxes[:table.count]
    wm = wb[None, :, 6] * o.abs().amax(1)[:, None] + wb[None, :, 7]
    wn, wf = _slab(o, d, wb[:, 0:3], wb[:, 3:6], wm)
    accepted = 0
    for i, s, e in instanced._instance_ranges(table.rows, cl):
        om, dm = instanced._xform(table.rows[i:i + 1, 0:12], o, d)
        t, _, _ = dense._pe_block(om, dm, tables.tris[s:e], 0.01)
        ray, row = torch.nonzero(t < 1e15, as_tuple=True)
        if not ray.numel():
            continue
        accepted += ray.numel()
        th = t[ray, row]
        assert bool(((wn[ray, i] <= th) & (th <= wf[ray, i])).all()), i
        cb = tables.boxes[s // cl:e // cl]
        mm = clustered.BOX_MARGIN * (tables.scale + om.abs().amax(1))
        cn, cf = _slab(om, dm, cb[:, 0:3], cb[:, 3:6],
                       mm[:, None].expand(-1, cb.shape[0]))
        c = row // cl
        assert bool(((cn[ray, c] <= th) & (th <= cf[ray, c])).all()), i
    assert accepted > 300


def test_gpu_instancing_without_trs(tmp_path):
    """EXT_mesh_gpu_instancing whose attributes hold no TRANSLATION,
    ROTATION or SCALE (only a custom per-instance attribute) loads as one
    instance at the node's transform; the JAX loader crashes there
    (ROADMAP.md Queue 3)."""
    import json
    path, _, _, _ = _write_gpu_instanced(tmp_path, n=8)
    doc = json.loads(open(path).read())
    doc["nodes"][0]["translation"] = [1.0, 2.0, 3.0]
    doc["nodes"][0]["extensions"]["EXT_mesh_gpu_instancing"] = dict(
        attributes=dict(_FEATURE_ID_0=1))
    p2 = tmp_path / "gpu_inst_custom.gltf"
    p2.write_text(json.dumps(doc))
    ws = tp.load_gltf(str(p2), instancing="flatten", device="cpu")
    assert ws.geom.num_tris == 1
    np.testing.assert_allclose(ws.geom.tri_v0.numpy()[0], [1.0, 2.0, 3.0])
    # Mismatched accessor counts raise a named error.
    doc["nodes"][0]["extensions"]["EXT_mesh_gpu_instancing"] = dict(
        attributes=dict(TRANSLATION=1, SCALE=0))
    p2.write_text(json.dumps(doc))
    with pytest.raises(ValueError, match="different counts"):
        tp.load_gltf(str(p2), instancing="flatten", device="cpu")


def test_eligibility_counts_table_padding(tmp_path, monkeypatch):
    """The eligibility bound counts the mesh table's padding to whole
    groups of clusters, so ``auto`` never picks a contract that packing
    then rejects (the JAX loader's bound skips it, ROADMAP.md Queue 3):
    one 12-triangle mesh packs to 1,024 rows, not 128."""
    path = _write_instanced_city(tmp_path)
    assert instanced.table_rows([12]) == 1024
    monkeypatch.setattr(instanced, "INST_MAX_ROWS", 512)
    with pytest.raises(ValueError, match="1024 rows"):
        tp.load_gltf(path, instancing="instanced", device="cpu")
    monkeypatch.setattr(instanced, "INST_MAX_ROWS", 1024)
    ws = tp.load_gltf(path, instancing="instanced", device="cpu")
    tables = instanced.prepare(ws.geom, ws.inst)
    assert tables.tris.shape[0] == 1024 and ws.inst.count == 12


def test_whitted_instanced_matches_flattened(tmp_path):
    """The same glTF loaded instanced and flattened renders the same
    Whitted image through the port (plain versions of K9/K10 against the
    brute force), within tests/test_instanced.py's bound for the JAX
    package (RMSE < 2e-3: interpolate-then-rotate against per-vertex
    rotated normals under non-uniform scale, and t noise)."""
    path = _write_instanced_city(tmp_path)
    ws_f = tp.load_gltf(path, instancing="flatten", device="cpu")
    ws_i = tp.load_gltf(path, instancing="instanced", device="cpu")
    assert ws_f.inst is None and ws_i.inst.count == 12
    cam = CameraArrays.from_camera(Camera(
        eye=np.array([0.0, 7.0, 14.0], np.float32),
        lookat=np.array([0.0, 0.0, 0.0], np.float32), fov_y=45.0),
        device="cpu")
    cfg = tp.RenderConfig(width=40, height=30, spp=1, max_depth=2,
                          background=(0.2, 0.3, 0.5), intersector="bruteforce")
    a, sa = render_whitted_wavefront(ws_f, cam, cfg, 0, 40 * 30, 0)
    b, sb = render_whitted_wavefront(ws_i, cam, cfg, 0, 40 * 30, 0)
    a, b = a.numpy(), b.numpy()
    assert np.isfinite(b).all()
    assert float(np.sqrt(np.mean((a - b) ** 2))) < 2e-3
    assert (np.abs(a - np.array([0.2, 0.3, 0.5])).max(-1) > 0.05).mean() > 0.08
    assert int(sa.rays_traced) == int(sb.rays_traced)


def test_wrappers_check_devices(fixture):
    """A wrapper takes CPU tensors (plain version) or CUDA tensors
    (kernel); any other device raises before anything runs."""
    tables = instanced.prepare(fixture["geom"], fixture["table"])
    o = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        instanced.closest_inst(o, o, tables.tris, tables.boxes, tables.scale,
                               tables.table.rows, tables.table.boxes, 0.01)
    assert dataclasses.is_dataclass(tables.table)
