"""The template tools of the PyTorch port held against the JAX package on
the CPU: the SMPL-family loader and forward (``body/family.py``),
subdivision and template baking (``body/subdivide.py``), UV baking
(``data/uv_baking.py``), and the ``extract_template`` / ``bake_uv`` entry
points against the JAX scripts' ``main`` on files written here.
"""

import importlib.util
import json
import os
import pickle
import shutil
import sys

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import torch

from sigman_release_tpu.body import family as jfamily
from sigman_release_tpu.body import smplx as jsmplx
from sigman_release_tpu.body import subdivide as jsub
from sigman_release_tpu.body import template as jtemplate
from sigman_release_tpu.body.template import compute_tbn as j_compute_tbn
from sigman_release_tpu.data import uv_baking as jbake
from sigman_release_torch import bake_uv, extract_template
from sigman_release_torch.body import family as tfamily
from sigman_release_torch.body import smplx as tsmplx
from sigman_release_torch.body import subdivide as tsub
from sigman_release_torch.body import template as ttemplate
from sigman_release_torch.data import uv_baking as tbake
from sigman_release_torch.geometry.cameras import orbit_camera
from sigman_release_torch.utils.image_io import image_size

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE_JPEG = os.path.join(ROOT, "tests", "torch_fixtures",
                            "hgs_view_1024.jpg")
# f32 results of the same numpy recipe, or of one f32 body forward in each
# package (rounding-level differences)
ATOL = 1e-5
# TBN frames of the procedural mesh: its strip faces have near-degenerate
# UV triangles, which amplify the forward's one-ulp vertex differences
# (and, through the cylindrical UVs, the face centres') up to this
ROT_ATOL = 5e-5


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _jax_script(name):
    """The JAX package's ``scripts/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------------ body family

@pytest.mark.parametrize("name,J,V,ext", [
    ("smpl", 24, 120, ".npz"), ("smplh", 52, 150, ".pkl"),
    ("mano", 16, 60, ".npz"), ("flame", 5, 40, ".pkl")])
def test_body_family_matches(tmp_path, name, J, V, ext):
    """Each family layout (SMPL 24 joints, SMPL-H 52, MANO 16, FLAME 5
    with 400 packed shape / expression dirs), as .npz or .pkl (posedirs
    [V,3,P], a scipy-sparse J_regressor, uint32 -1 parent): the loaded
    arrays equal, the forward (verts, joints, A, T) within 1e-5."""
    rng = np.random.default_rng(J)
    parents = np.zeros((2, J), np.int64)
    parents[0] = np.maximum(np.arange(J) - 1 - rng.integers(0, 3, J), 0)
    parents[0, 0] = 4294967295
    n_shape = 400 if name == "flame" else 10
    jr = rng.uniform(0, 1, (J, V)) * (rng.uniform(size=(J, V)) < 0.2)
    jr = (jr / np.maximum(jr.sum(1, keepdims=True), 1e-6)).astype(np.float32)
    assets = dict(
        v_template=rng.normal(0, 0.2, (V, 3)).astype(np.float32),
        shapedirs=rng.normal(0, 0.01, (V, 3, n_shape)).astype(np.float32),
        posedirs=rng.normal(0, 0.001, (V, 3, (J - 1) * 9)).astype(np.float32),
        J_regressor=jr,
        weights=np.eye(J, dtype=np.float32)[rng.integers(0, J, V)],
        kintree_table=parents,
        f=rng.integers(0, V, (2 * V, 3)),
    )
    path = str(tmp_path / f"{name}{ext}")
    if ext == ".pkl":
        with open(path, "wb") as f:
            pickle.dump(assets, f)
        # the JAX loader wraps a sparse matrix in an object array and fails
        # (ROADMAP queue 3), so it reads the dense file; the port both
        sparse = str(tmp_path / f"{name}_sparse.pkl")
        with open(sparse, "wb") as f:
            pickle.dump(assets | {"J_regressor": scipy.sparse.csc_matrix(jr)},
                        f)
        for k, v in tfamily.load_body_npz(sparse)._asdict().items():
            np.testing.assert_array_equal(
                _np(v), _np(getattr(tfamily.load_body_npz(path), k)))
    else:
        np.savez(path, **assets)
    jm = jfamily.load_body_npz(path)
    tm = tfamily.load_body_npz(path)
    assert tm.num_joints == jm.num_joints == J
    assert tm.num_verts == jm.num_verts == V
    for k in jm._fields:
        np.testing.assert_array_equal(_np(getattr(tm, k)),
                                      _np(getattr(jm, k)), err_msg=k)
    betas = rng.normal(0, 1, (2, 10)).astype(np.float32)
    pose = rng.normal(0, 0.2, (2, J * 3)).astype(np.float32)
    transl = np.array([[0.0, 0.0, 0.0], [0.1, 1.0, -0.2]], np.float32)
    jo = jfamily.body_forward(jm, jnp.asarray(betas), jnp.asarray(pose),
                              transl=jnp.asarray(transl))
    to = tfamily.body_forward(tm, torch.from_numpy(betas),
                              torch.from_numpy(pose),
                              transl=torch.from_numpy(transl))
    for k in ("verts", "joints", "A", "T"):
        np.testing.assert_allclose(_np(getattr(to, k)), _np(getattr(jo, k)),
                                   atol=ATOL, err_msg=k)


# ------------------------------------------------ subdivision and baking

@pytest.fixture(scope="module")
def body(tmp_path_factory):
    """A procedural body in the SMPL-X npz layout, loaded by each package."""
    path = str(tmp_path_factory.mktemp("body") / "smplx.npz")
    tsmplx.save_smplx_npz(tsmplx.synthetic_body_model(n_verts=256, seed=1),
                          path)
    return path, jsmplx.load_smplx_npz(path), tsmplx.load_smplx_npz(path)


REGIONS = [list(range(10, 80)), list(range(150, 200)), [3, 4, 5, 6]]


def test_save_smplx_npz_round_trip(body):
    path, jm, tm = body
    ref = tsmplx.synthetic_body_model(n_verts=256, seed=1)
    for k in ref._fields:
        np.testing.assert_array_equal(_np(getattr(tm, k)),
                                      _np(getattr(ref, k)), err_msg=k)
        np.testing.assert_array_equal(_np(getattr(jm, k)),
                                      _np(getattr(ref, k)), err_msg=k)


def test_region_faces_and_subdivide_match(body):
    """Masks, faces and midpoint order exact; positions and attributes of
    the same inputs equal."""
    _, jm, _ = body
    faces = np.asarray(jm.faces)
    for region in REGIONS:
        np.testing.assert_array_equal(tsub.region_faces(faces, region),
                                      jsub.region_faces(faces, region))
    mask = np.logical_or.reduce([jsub.region_faces(faces, r)
                                 for r in REGIONS])
    rng = np.random.default_rng(0)
    verts = rng.normal(size=(256, 3)).astype(np.float32)
    attrs = {"a": rng.normal(size=(256, 5)).astype(np.float32),
             "b": rng.normal(size=(256, 3, 7)).astype(np.float32)}
    a = jsub.subdivide(verts, faces, mask, attrs)
    b = tsub.subdivide(verts, faces, mask, attrs)
    for x, y in zip((a[0], a[1], a[3]), (b[0], b[1], b[3])):
        np.testing.assert_array_equal(y, x)
    for k in attrs:
        np.testing.assert_array_equal(b[2][k], a[2][k])
    assert a[3].sum() == 4 * mask.sum()


@pytest.mark.parametrize("regions", [None, REGIONS], ids=["whole", "regions"])
@pytest.mark.parametrize("with_uv", [False, True], ids=["cylinder", "uv"])
def test_bake_template_matches(body, regions, with_uv):
    """Faces and the subdivided-face mask exact; anchors, UVs, weights and
    blend dirs within 1e-5; TBN frames equal to the JAX ``compute_tbn`` of
    the port's own mesh and UVs within 1e-5 and to the JAX bake within
    ``ROT_ATOL``."""
    _, jm, tm = body
    vert_uv = (np.random.default_rng(2).uniform(0, 1, (256, 2))
               .astype(np.float32) if with_uv else None)
    a = jsub.bake_template(jm, regions, vert_uv)
    b = tsub.bake_template(tm, regions, vert_uv)
    np.testing.assert_array_equal(b.init_faces, a.init_faces)
    np.testing.assert_array_equal(b.face_mask, a.face_mask)
    assert b.num_gaussians == a.num_gaussians > 254 * (regions is not None)
    for k in ("init_uv", "init_pcd", "init_lbsw", "init_spdir", "init_podir"):
        np.testing.assert_allclose(_np(getattr(b, k)), _np(getattr(a, k)),
                                   atol=ATOL, err_msg=k)
    # the port's subdivided mesh and per-vertex UV, rebuilt here
    verts = _np(tsmplx.smplx_forward(tm, tsmplx.canonical_params(1)).verts[0])
    attrs = {"uv": vert_uv} if with_uv else {}
    if regions:
        faces = np.asarray(tm.faces)
        mask = np.logical_or.reduce([tsub.region_faces(faces, r)
                                     for r in regions])
        verts, _, attrs, _ = tsub.subdivide(verts, faces, mask, attrs)
    uv = attrs["uv"] if with_uv else tsub.vertex_average(
        _np(b.init_uv), b.init_faces, verts.shape[0])
    np.testing.assert_allclose(
        _np(b.init_rot), np.asarray(j_compute_tbn(verts, b.init_faces, uv)),
        atol=ATOL)
    np.testing.assert_allclose(_np(b.init_rot), _np(a.init_rot),
                               atol=ROT_ATOL)


def test_template_dir_round_trip(body, tmp_path):
    """A JAX-written directory read by the port's ``load_template_dir``,
    and a port-written one read by the JAX ``load_template_dir``: every
    array equal to its writer's."""
    _, jm, tm = body
    a = jsub.bake_template(jm, REGIONS)
    b = tsub.bake_template(tm, REGIONS)
    jsub.save_template_dir(a, str(tmp_path / "jax"))
    tsub.save_template_dir(b, str(tmp_path / "port"))
    for written, read in ((a, ttemplate.load_template_dir(
            str(tmp_path / "jax"))), (b, jtemplate.load_template_dir(
                str(tmp_path / "port")))):
        for k in ("init_uv", "init_pcd", "init_rot", "init_faces",
                  "init_lbsw", "init_spdir", "init_podir", "face_mask"):
            np.testing.assert_array_equal(_np(getattr(read, k)),
                                          _np(getattr(written, k)),
                                          err_msg=k)
        assert read.hands_mask is None and read.outside_mask is None


# --------------------------------------------------------------- UV baking

K64 = np.array([[64.0, 0, 32.0], [0, 64.0, 32.0], [0, 0, 1]])


def _mesh():
    """40 seeded triangles in front of the camera, then two coplanar
    overlapping faces at one depth (ids 40 and 41)."""
    rng = np.random.default_rng(0)
    n = 40
    verts = np.concatenate([rng.uniform(-0.6, 0.6, (3 * n, 2)),
                            rng.uniform(1.5, 3.0, (3 * n, 1))], 1)
    pair = [[-0.3, -0.3, 2.0], [0.3, -0.3, 2.0], [0.0, 0.3, 2.0],
            [-0.2, -0.35, 2.0], [0.35, -0.1, 2.0], [-0.1, 0.35, 2.0]]
    verts = np.concatenate([verts, pair]).astype(np.float32)
    faces = np.concatenate([np.arange(3 * n).reshape(n, 3),
                            [[3 * n, 3 * n + 1, 3 * n + 2],
                             [3 * n + 3, 3 * n + 4, 3 * n + 5]]])
    return verts, faces.astype(np.int64)


@pytest.mark.parametrize("chunk", [1 << 25, 3000], ids=["one", "chunked"])
def test_rasterize_mesh_matches(monkeypatch, chunk):
    """64^2, in one chunk and in many: face ids exact (the coplanar pair's
    overlap goes to the lower id), barycentrics, depth and view cosines
    within 1e-5."""
    monkeypatch.setattr(tbake, "CANDIDATES_PER_CHUNK", chunk)
    verts, faces = _mesh()
    w2c = np.eye(4)
    w2c[:3, 3] = [0.05, -0.02, 0.1]
    a = jbake.rasterize_mesh(verts, faces, w2c, K64, 64, 64)
    b = tbake.rasterize_mesh(verts, faces, w2c, K64, 64, 64)
    np.testing.assert_array_equal(b["face_id"].numpy(), a["face_id"])
    for k in ("bary", "depth", "viewcos"):
        np.testing.assert_allclose(b[k].numpy(), a[k], atol=ATOL, err_msg=k)
    # the coplanar pair: where both cover a pixel, face 40 shows
    pair = jbake.rasterize_mesh(verts, faces[40:], w2c, K64, 64, 64)
    second = jbake.rasterize_mesh(verts, faces[41:], w2c, K64, 64, 64)
    both = (pair["face_id"] >= 0) & (second["face_id"] >= 0)
    solo = tbake.rasterize_mesh(verts, faces[40:], w2c, K64, 64, 64)
    assert both.sum() > 50
    assert (solo["face_id"].numpy()[both] == 0).mean() > 0.5
    np.testing.assert_array_equal(solo["face_id"].numpy(), pair["face_id"])


def _samples(rng, n, T):
    uv = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    uv[:5] = [[0, 0], [1, 1], [0, 1], [1.0, 0.3], [0.5, 1.0]]
    return (uv, rng.uniform(0, 1, (n, 3)).astype(np.float32),
            rng.uniform(0.6, 1, n).astype(np.float32))


def test_scatter_mip_dilate_match():
    """``scatter_average`` into the atlas, ``mip_fill`` of sparse samples
    and ``dilate_texture`` (wrapping at the atlas border): within 1e-5 of
    the JAX package's float32 accumulation."""
    rng = np.random.default_rng(5)
    T = 64
    uv, vals, w = _samples(rng, 300, T)
    jt, jw = np.zeros((T, T, 3), np.float32), np.zeros((T, T), np.float32)
    tt = torch.zeros((T, T, 3), dtype=torch.float64)
    tw = torch.zeros((T, T), dtype=torch.float64)
    targs = [torch.from_numpy(a) for a in (uv, vals, w)]
    jbake.scatter_average(jt, jw, uv, vals, w)
    tbake.scatter_average(tt, tw, *targs)
    np.testing.assert_allclose(tt.numpy(), jt, atol=ATOL)
    np.testing.assert_allclose(tw.numpy(), jw, atol=ATOL)
    jbake.mip_fill(jt, jw, uv, vals, w, min_resolution=8)
    tbake.mip_fill(tt, tw, *targs, min_resolution=8)
    assert (jw > 1e-6).mean() > 0.9
    np.testing.assert_allclose(tt.numpy(), jt, atol=ATOL)
    np.testing.assert_allclose(tw.numpy(), jw, atol=ATOL)
    # dilation from a few covered texels, two of them on the border
    tex = rng.uniform(0, 1, (T, T, 3)).astype(np.float32)
    wt = np.zeros((T, T), np.float32)
    wt[[0, 40, 63], [5, 20, 63]] = 1.0
    a = jbake.dilate_texture(tex, wt, iterations=6)
    b = tbake.dilate_texture(torch.from_numpy(tex), torch.from_numpy(wt),
                             iterations=6)
    np.testing.assert_allclose(b.numpy(), a, atol=ATOL)
    assert a[63, 0].any()       # the flood wrapped across the corner


def test_bake_uv_texture_matches():
    """Two views of the seeded mesh at 64^2 into a 64^2 atlas: within 1e-5;
    ``stats`` counts the samples and the covered texels."""
    rng = np.random.default_rng(9)
    verts, faces = _mesh()
    uv = rng.uniform(0, 1, (len(verts), 2)).astype(np.float32)
    imgs = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    w2cs = np.stack([np.eye(4), np.eye(4)])
    w2cs[1, :3, 3] = [0.1, 0.0, 0.05]
    a = jbake.bake_uv_texture(verts, faces, uv, imgs, w2cs, K64,
                              texture_size=64)
    stats = {}
    b = tbake.bake_uv_texture(verts, faces, uv, imgs, w2cs, K64,
                              texture_size=64, stats=stats)
    assert b.dtype == torch.float32
    np.testing.assert_allclose(b.numpy(), a, atol=ATOL)
    assert stats["samples"] > 100 and 0 < stats["direct"] < stats["covered"]


# ------------------------------------------------------ the entry points

def test_extract_template_matches_the_jax_script(body, tmp_path, monkeypatch):
    """``extract_template --smplx --seg --out`` against the JAX script on
    the same files: template arrays within 1e-5 (TBN frames within
    ``ROT_ATOL``), faces and mask exact; regions the JSON lacks are
    skipped by both."""
    path, _, _ = body
    seg = {name: list(range(20 * i, 20 * i + 15))
           for i, name in enumerate(extract_template.SUBDIVIDE_REGIONS[:7])}
    seg["rightFoot"] = list(range(200, 250))
    seg_path = str(tmp_path / "seg.json")
    with open(seg_path, "w") as f:
        json.dump(seg, f)
    js = _jax_script("extract_template")
    assert js.SUBDIVIDE_REGIONS == extract_template.SUBDIVIDE_REGIONS
    monkeypatch.setattr(sys, "argv", [
        "extract_template.py", "--smplx", path, "--seg", seg_path, "--out",
        str(tmp_path / "jax")])
    js.main()
    t = extract_template.main(["--smplx", path, "--seg", seg_path, "--out",
                               str(tmp_path / "port"), "--device", "cpu"])
    a = jtemplate.load_template_dir(str(tmp_path / "jax"))
    b = ttemplate.load_template_dir(str(tmp_path / "port"))
    assert b.num_gaussians == t.num_gaussians == a.num_gaussians > 254
    np.testing.assert_array_equal(b.init_faces, a.init_faces)
    np.testing.assert_array_equal(b.face_mask, a.face_mask)
    for k in ("init_uv", "init_pcd", "init_lbsw", "init_spdir", "init_podir"):
        np.testing.assert_allclose(_np(getattr(b, k)), _np(getattr(a, k)),
                                   atol=ATOL, err_msg=k)
    np.testing.assert_allclose(_np(b.init_rot), _np(a.init_rot),
                               atol=ROT_ATOL)


BAKE_VIEWS = (30, 0)


def _write_bake_items(root):
    """Two items with the 1024^2 JPEG fixture as views 30 and 0 (orbit
    cameras facing the body), and a third without a camera file."""
    dirs = []
    for i in range(3):
        d = os.path.join(root, f"item{i}")
        os.makedirs(os.path.join(d, "rgb_map"))
        cams = {}
        for vid in BAKE_VIEWS:
            shutil.copyfile(FIXTURE_JPEG,
                            os.path.join(d, "rgb_map", f"{vid:04d}.jpg"))
            w2c = np.linalg.inv(orbit_camera(10.0, 4.0 * vid + 7 * i, 1.5))
            cams[f"{vid:04d}"] = {"R": w2c[:3, :3].tolist(),
                                  "T": w2c[:3, 3].tolist()}
        if i < 2:
            with open(os.path.join(d, "camera_full_calibration.json"),
                      "w") as f:
                json.dump(cams, f)
        dirs.append(d)
    lst = os.path.join(root, "items.npy")
    np.save(lst, np.array(dirs))
    return dirs, lst


def _write_obj(path, verts):
    """An OBJ of ``verts`` (float32 round trip exact) and one face."""
    with open(path, "w") as f:
        f.write("".join(f"v {x!r} {y!r} {z!r}\n"
                        for x, y, z in verts.astype(float).tolist())
                + "f 1 2 3\n")


def test_bake_uv_matches_the_jax_script(body, tmp_path, monkeypatch):
    """``bake_uv`` against the JAX script over the same item directories
    (the committed 1024^2 JPEG fixture as 2 of the 18 views, the others
    missing, a 1024^2 atlas): each PNG within 1 level of the JAX one;
    ``wrong_id.npy`` names the same broken item. Each item's posed mesh
    (``smplx_posed.obj``, which the JAX script does not read) holds the JAX
    package's canonical vertices, so both scripts rasterize one geometry:
    the two packages' forwards differ by an ulp, which moves pixels on
    face edges between faces."""
    path, jm, _ = body
    dirs, lst = _write_bake_items(str(tmp_path / "items"))
    verts = np.asarray(jsmplx.smplx_forward(jm, jsmplx.canonical_params(1))
                       .verts[0])
    for d in dirs:
        _write_obj(os.path.join(d, "smplx_posed.obj"), verts)
    js = _jax_script("bake_uv")
    assert js.DEFAULT_VIEW_IDS == bake_uv.DEFAULT_VIEW_IDS
    out = {}
    for side in ("jax", "port"):
        os.makedirs(tmp_path / side)
        monkeypatch.chdir(tmp_path / side)
        if side == "jax":
            monkeypatch.setattr(sys, "argv", ["bake_uv.py", "--items", lst,
                                              "--smplx", path])
            js.main()
        else:
            res = bake_uv.main(["--items", lst, "--smplx", path, "--device",
                                "cpu"])
        out[side] = [cv2.imread(os.path.join(d, "UV", "smplxuv_albedo.png"))
                     [..., ::-1].copy() for d in dirs[:2]]
        out[side + "_wrong"] = list(np.load("wrong_id.npy"))
        for d in dirs[:2]:
            os.remove(os.path.join(d, "UV", "smplxuv_albedo.png"))
    assert out["port_wrong"] == out["jax_wrong"] == [dirs[2]]
    assert [r[0] for r in res["baked"]] == dirs[:2]
    assert res["wrong"] == [dirs[2]]
    for a, b in zip(out["jax"], out["port"]):
        assert a.shape == b.shape == (1024, 1024, 3)
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
        assert a.std() > 5       # a texture, not a flat fill
    assert image_size(FIXTURE_JPEG) == (1024, 1024)


def test_bake_uv_reads_the_posed_mesh(body, tmp_path):
    """``--mesh_name``: an item's posed OBJ replaces the canonical mesh
    (the JAX script parses the flag and never reads it), and the bake
    equals ``bake_item`` on those vertices; an OBJ with another vertex
    count fails the item."""
    path, _, tm = body
    dirs, lst = _write_bake_items(str(tmp_path / "items"))
    verts = _np(tsmplx.smplx_forward(tm, tsmplx.canonical_params(1))
                .verts[0]) + np.float32([0.02, -0.05, 0.0])
    _write_obj(os.path.join(dirs[0], "posed.obj"), verts)
    _write_obj(os.path.join(dirs[1], "posed.obj"), verts[:3])
    np.save(lst, np.array(dirs[:2]))
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        res = bake_uv.main(["--items", lst, "--smplx", path, "--mesh_name",
                            "posed.obj", "--texture_size", "128",
                            "--device", "cpu"])
    finally:
        os.chdir(cwd)
    assert [r[0] for r in res["baked"]] == dirs[:1]
    assert res["wrong"] == dirs[1:2]
    got = cv2.imread(res["baked"][0][1])[..., ::-1]
    template = tsub.bake_template(tm)
    vert_uv = tsub.vertex_average(_np(template.init_uv), template.init_faces,
                                  len(verts))
    ref = bake_uv.bake_item(dirs[0], vert_uv, np.asarray(tm.faces),
                            bake_uv.read_obj_vertices(
                                os.path.join(dirs[0], "posed.obj")),
                            bake_uv.DEFAULT_VIEW_IDS, 128)
    np.testing.assert_array_equal(got, cv2.imread(ref)[..., ::-1])
    canon = bake_uv.bake_item(dirs[0], vert_uv, np.asarray(tm.faces),
                              verts - np.float32([0.02, -0.05, 0.0]),
                              bake_uv.DEFAULT_VIEW_IDS, 128)
    assert not np.array_equal(got, cv2.imread(canon)[..., ::-1])
