"""The port's COLMAP modules (``nerf_tpu_torch/utils/colmap.py``,
``colmap_database.py``, ``colmap_export.py``) and ``python -m
nerf_tpu_torch.colmap2nerf`` against the JAX package's, on the models,
databases and exports that ``tests/test_colmap.py`` writes.

The modules are numpy and sqlite3 only, copies of the JAX package's, so
the bar is bit for bit: every file either side writes has the same bytes,
each side reads the other's files into equal objects, the database holds
the same rows (``iterdump``), and the CLI's ``transforms.json`` is the same
text as ``scripts/colmap2nerf.py``'s.
"""
import dataclasses
import importlib.util
import json
import os

import numpy as np
import pytest

from nerf_tpu.utils import colmap as jcolmap
from nerf_tpu.utils import colmap_database as jdb
from nerf_tpu.utils import colmap_export as jexport

from nerf_tpu_torch import colmap2nerf
from nerf_tpu_torch.utils import colmap, colmap_database, colmap_export

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _model(mod=colmap, cam_model="PINHOLE", params=(700.0, 710.0, 400.0, 300.0)):
    """tests/test_colmap.py's model, built from ``mod``'s types."""
    rng = np.random.RandomState(0)
    cams = {1: mod.Camera(1, cam_model, 800, 600, np.array(params))}
    imgs = {}
    for i in range(1, 4):
        q = rng.randn(4)
        q /= np.linalg.norm(q)
        q *= np.sign(q[0]) if q[0] != 0 else 1
        imgs[i] = mod.Image(i, q, rng.randn(3), 1, f"img_{i}.png", rng.rand(5, 2) * 100,
                            rng.randint(-1, 10, 5).astype(np.int64))
    pts = {7: mod.Point3D(7, rng.randn(3), np.array([10, 20, 30], np.uint8), 0.5,
                          np.array([1, 2], np.int64), np.array([0, 1], np.int64)),
           9: mod.Point3D(9, np.array([1.0, 2.0, -3.5]), np.array([255, 0, 128], np.uint8),
                          1.25, np.array([3], np.int64), np.array([0], np.int64))}
    return cams, imgs, pts


def _same(a, b):
    """Two COLMAP records (either package's dataclasses) or dicts of them."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
        return
    fa, fb = dataclasses.asdict(a), dataclasses.asdict(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        va, vb = np.asarray(fa[k]), np.asarray(fb[k])
        assert va.dtype == vb.dtype and va.shape == vb.shape, k
        np.testing.assert_array_equal(va, vb, err_msg=k)


KINDS = [("cameras", 0), ("images", 1), ("points3d", 2)]


@pytest.mark.parametrize("ext", ["bin", "txt"])
@pytest.mark.parametrize("kind,i", KINDS)
def test_model_files_match_jax_both_ways(tmp_path, kind, i, ext):
    name = {"cameras": "cameras", "images": "images", "points3d": "points3D"}[kind]
    port_path, jax_path = str(tmp_path / f"p_{name}.{ext}"), str(tmp_path / f"j_{name}.{ext}")
    getattr(colmap, f"write_{kind}_{ext}")(port_path, _model(colmap)[i])
    getattr(jcolmap, f"write_{kind}_{ext}")(jax_path, _model(jcolmap)[i])
    assert open(port_path, "rb").read() == open(jax_path, "rb").read()
    got = getattr(colmap, f"read_{kind}_{ext}")(jax_path)
    want = getattr(jcolmap, f"read_{kind}_{ext}")(port_path)
    _same(got, want)


@pytest.mark.parametrize("ext", ["bin", "txt"])
def test_read_model_matches_jax(tmp_path, ext):
    cams, imgs, pts = _model(jcolmap)
    jcolmap.__dict__[f"write_cameras_{ext}"](str(tmp_path / f"cameras.{ext}"), cams)
    jcolmap.__dict__[f"write_images_{ext}"](str(tmp_path / f"images.{ext}"), imgs)
    jcolmap.__dict__[f"write_points3d_{ext}"](str(tmp_path / f"points3D.{ext}"), pts)
    for a, b in zip(colmap.read_model(str(tmp_path)), jcolmap.read_model(str(tmp_path))):
        _same(a, b)


def test_quaternions_and_poses_match_jax():
    rng = np.random.RandomState(1)
    _, imgs, _ = _model(colmap)
    _, jimgs, _ = _model(jcolmap)
    for i in imgs:
        np.testing.assert_array_equal(colmap.image_c2w(imgs[i]), jcolmap.image_c2w(jimgs[i]))
    for _ in range(10):
        q = rng.randn(4)
        q /= np.linalg.norm(q)
        R = colmap.qvec2rotmat(q)
        np.testing.assert_array_equal(R, jcolmap.qvec2rotmat(q))
        np.testing.assert_array_equal(colmap.rotmat2qvec(R), jcolmap.rotmat2qvec(R))
        np.testing.assert_allclose(colmap.rotmat2qvec(R), q * np.sign(q[0]), atol=1e-8)


@pytest.mark.parametrize("shape", [(5, 7), (5, 7, 3)])
def test_dense_arrays_match_jax(tmp_path, shape):
    arr = np.random.RandomState(0).rand(*shape).astype(np.float32)
    colmap.write_array(str(tmp_path / "p.bin"), arr)
    jcolmap.write_array(str(tmp_path / "j.bin"), arr)
    assert (tmp_path / "p.bin").read_bytes() == (tmp_path / "j.bin").read_bytes()
    np.testing.assert_array_equal(colmap.read_array(str(tmp_path / "j.bin")),
                                  jcolmap.read_array(str(tmp_path / "p.bin")))


def _cloud(mod, n, seed, vis=True):
    r = np.random.RandomState(seed)
    return [mod.MeshPoint(position=r.rand(3).astype(np.float32),
                          normal=r.rand(3).astype(np.float32),
                          color=r.randint(0, 255, 3).astype(np.uint8),
                          visible_image_idxs=np.asarray(
                              r.randint(0, 9, r.randint(0, 4)) if vis else [], np.uint32))
            for _ in range(n)]


def test_fused_clouds_match_jax(tmp_path):
    colmap.write_fused(_cloud(colmap, 4, 1), str(tmp_path / "p.ply"), str(tmp_path / "p.vis"))
    jcolmap.write_fused(_cloud(jcolmap, 4, 1), str(tmp_path / "j.ply"), str(tmp_path / "j.vis"))
    for ext in ("ply", "vis"):
        assert (tmp_path / f"p.{ext}").read_bytes() == (tmp_path / f"j.{ext}").read_bytes()
    got = colmap.read_fused(str(tmp_path / "j.ply"), str(tmp_path / "j.vis"))
    want = jcolmap.read_fused(str(tmp_path / "p.ply"), str(tmp_path / "p.vis"))
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        _same(a, b)


def _fill_database(mod, path):
    """tests/test_colmap.py's database: two cameras, two images, keypoints,
    descriptors, matches given in reversed order, a two-view geometry."""
    db = mod.COLMAPDatabase.connect(path)
    db.create_tables()
    rng = np.random.RandomState(2)
    cam1 = db.add_camera(model=1, width=800, height=600, params=[500.0, 400.0, 300.0, 0.1])
    cam2 = db.add_camera(model=0, width=640, height=480, params=[400.0, 320.0, 240.0])
    im1, im2 = db.add_image("a.png", cam1), db.add_image("b.png", cam2)
    db.add_keypoints(im1, rng.rand(32, 2).astype(np.float32) * 800)
    db.add_descriptors(im1, rng.randint(0, 256, (32, 128)).astype(np.uint8))
    matches = rng.randint(0, 32, (10, 2)).astype(np.uint32)
    db.add_matches(im2, im1, matches)
    db.add_two_view_geometry(im1, im2, rng.randint(0, 32, (20, 2)).astype(np.uint32))
    db.commit()
    return db, im1, im2


def test_databases_match_jax(tmp_path):
    db, im1, im2 = _fill_database(colmap_database, str(tmp_path / "p.db"))
    jdb_, _, _ = _fill_database(jdb, str(tmp_path / "j.db"))
    assert list(db.iterdump()) == list(jdb_.iterdump())
    for read in ("read_cameras", "read_images"):
        got, want = getattr(db, read)(), getattr(jdb_, read)()
        assert got.keys() == want.keys()
        for k in got:
            for f in got[k]:
                np.testing.assert_array_equal(got[k][f], want[k][f])
    np.testing.assert_array_equal(db.read_keypoints(im1), jdb_.read_keypoints(im1))
    np.testing.assert_array_equal(db.read_descriptors(im1), jdb_.read_descriptors(im1))
    for a, b in ((im2, im1), (im1, im2)):
        np.testing.assert_array_equal(db.read_matches(a, b), jdb_.read_matches(a, b))
    for a, b in ((1, 2), (7, 3), (2**20, 5)):
        pid = colmap_database.image_ids_to_pair_id(a, b)
        assert pid == jdb.image_ids_to_pair_id(a, b)
        assert colmap_database.pair_id_to_image_ids(pid) == jdb.pair_id_to_image_ids(pid)
    blob = colmap_database.array_to_blob(np.arange(6, dtype=np.float32))
    assert blob == jdb.array_to_blob(np.arange(6, dtype=np.float32))
    np.testing.assert_array_equal(colmap_database.blob_to_array(blob, np.float32, (2, 3)),
                                  jdb.blob_to_array(blob, np.float32, (2, 3)))
    db.close()
    jdb_.close()


def _tiny_model(mod):
    """tests/test_colmap.py's exporter model."""
    rng = np.random.RandomState(5)
    cams = {1: mod.Camera(id=1, model="SIMPLE_PINHOLE", width=64, height=48,
                          params=np.array([50.0, 32.0, 24.0]))}
    imgs = {}
    for i in (1, 2):
        theta = 0.3 * i
        R = np.array([[np.cos(theta), -np.sin(theta), 0], [np.sin(theta), np.cos(theta), 0],
                      [0, 0, 1.0]])
        imgs[i] = mod.Image(id=i, qvec=mod.rotmat2qvec(R), tvec=rng.rand(3), camera_id=1,
                            name=f"im{i}.png")
    pts = {3: mod.Point3D(id=3, xyz=np.array([0.5, -0.25, 2.0]),
                          rgb=np.array([200, 100, 50], np.uint8), error=0.1,
                          image_ids=np.array([1, 2]), point2D_idxs=np.array([7, 9]))}
    return cams, imgs, pts


def test_bundler_and_nvm_exports_match_jax(tmp_path):
    colmap_export.write_bundler(str(tmp_path / "p.out"), *_tiny_model(colmap),
                                list_path=str(tmp_path / "p.txt"))
    jexport.write_bundler(str(tmp_path / "j.out"), *_tiny_model(jcolmap),
                          list_path=str(tmp_path / "j.txt"))
    colmap_export.write_nvm(str(tmp_path / "p.nvm"), *_tiny_model(colmap))
    jexport.write_nvm(str(tmp_path / "j.nvm"), *_tiny_model(jcolmap))
    for ext in ("out", "txt", "nvm"):
        text = (tmp_path / f"p.{ext}").read_bytes()
        assert text and text == (tmp_path / f"j.{ext}").read_bytes(), ext


def test_inlier_exports_and_ply_merge_match_jax(tmp_path):
    outs = {}
    for tag, dbmod, exp, cmod in (("p", colmap_database, colmap_export, colmap),
                                  ("j", jdb, jexport, jcolmap)):
        db = dbmod.COLMAPDatabase.connect(str(tmp_path / f"{tag}.db"))
        db.create_tables()
        cam = db.add_camera(0, 64, 48, [50.0, 32.0, 24.0])
        i1, i2, i3 = (db.add_image(n, cam) for n in ("a.png", "b.png", "c.png"))
        rng = np.random.RandomState(6)
        db.add_two_view_geometry(i1, i2, rng.randint(0, 30, (20, 2)).astype(np.uint32))
        db.add_two_view_geometry(i3, i2, rng.randint(0, 30, (17, 2)).astype(np.uint32))
        db.commit()
        for n in (15, 18, 25):
            exp.export_inlier_matches(db, str(tmp_path / f"{tag}_m{n}.txt"), min_num_matches=n)
        exp.export_inlier_pairs(db, str(tmp_path / f"{tag}_pairs.txt"))
        db.close()
        for name, seed, n in (("a", 1, 3), ("b", 2, 2)):
            cmod.write_fused(_cloud(cmod, n, seed, vis=False), str(tmp_path / f"{tag}{name}.ply"),
                             str(tmp_path / f"{tag}{name}.ply.vis"))
        exp.merge_ply_files([str(tmp_path / f"{tag}a.ply"), str(tmp_path / f"{tag}b.ply")],
                            str(tmp_path / f"{tag}_merged.ply"))
        outs[tag] = {f[2:]: (tmp_path / f).read_bytes() for f in os.listdir(tmp_path)
                     if f.startswith(f"{tag}_")}
    assert len(outs["p"]) == 5 and outs["p"] == outs["j"]
    assert outs["p"]["m15.txt"].startswith(b"a.png b.png 20")


def _jax_colmap2nerf():
    spec = importlib.util.spec_from_file_location(
        "jax_colmap2nerf", os.path.join(ROOT, "scripts", "colmap2nerf.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("cam_model,params", [
    ("PINHOLE", (700.0, 710.0, 400.0, 300.0)), ("SIMPLE_PINHOLE", (650.0, 400.0, 300.0)),
    ("SIMPLE_RADIAL", (640.0, 401.0, 299.0, 0.01)),
    ("OPENCV", (700.0, 705.0, 398.0, 301.0, 0.01, -0.02, 1e-3, 2e-3))])
@pytest.mark.parametrize("ext", ["bin", "txt"])
@pytest.mark.parametrize("extra", [[], ["--keep_colmap_coords"], ["--aabb_scale", "8",
                                                                   "--images", "rgb"]])
def test_colmap2nerf_writes_jax_s_transforms(tmp_path, cam_model, params, ext, extra, capsys):
    cams, imgs, pts = _model(colmap, cam_model, params)
    for kind, obj in (("cameras", cams), ("images", imgs), ("points3d", pts)):
        name = "points3D" if kind == "points3d" else kind
        getattr(colmap, f"write_{kind}_{ext}")(str(tmp_path / f"{name}.{ext}"), obj)
    port_out, jax_out = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    got = colmap2nerf.main(["--model_dir", str(tmp_path), "--out", port_out, *extra])
    _jax_colmap2nerf().main(["--model_dir", str(tmp_path), "--out", jax_out, *extra])
    assert open(port_out).read() == open(jax_out).read()
    assert got == json.load(open(jax_out))
    assert len(got["frames"]) == 3 and capsys.readouterr().out.count("wrote ") == 2
