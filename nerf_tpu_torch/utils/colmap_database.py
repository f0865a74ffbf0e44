"""COLMAP SQLite database I/O.

The port's copy of ``nerf_tpu/utils/colmap_database.py`` (numpy and stdlib
``sqlite3``). The reference vendors COLMAP's ``database.py``
(``src/utils/colmap/database.py``); this implements the public COLMAP
database schema (cameras / images / keypoints / descriptors / matches /
two_view_geometries): creating a database, registering cameras and images,
storing features and matches, and reading them back.
"""
from __future__ import annotations

import sqlite3
from typing import Dict, Optional, Tuple

import numpy as np

MAX_IMAGE_ID = 2 ** 31 - 1

_SCHEMA = """
CREATE TABLE IF NOT EXISTS cameras (
    camera_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    model INTEGER NOT NULL,
    width INTEGER NOT NULL,
    height INTEGER NOT NULL,
    params BLOB,
    prior_focal_length INTEGER NOT NULL);
CREATE TABLE IF NOT EXISTS images (
    image_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    name TEXT NOT NULL UNIQUE,
    camera_id INTEGER NOT NULL,
    prior_qw REAL, prior_qx REAL, prior_qy REAL, prior_qz REAL,
    prior_tx REAL, prior_ty REAL, prior_tz REAL,
    CONSTRAINT image_id_check CHECK(image_id >= 0 and image_id < {max_id}),
    FOREIGN KEY(camera_id) REFERENCES cameras(camera_id));
CREATE TABLE IF NOT EXISTS keypoints (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL,
    cols INTEGER NOT NULL,
    data BLOB,
    FOREIGN KEY(image_id) REFERENCES images(image_id) ON DELETE CASCADE);
CREATE TABLE IF NOT EXISTS descriptors (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL,
    cols INTEGER NOT NULL,
    data BLOB,
    FOREIGN KEY(image_id) REFERENCES images(image_id) ON DELETE CASCADE);
CREATE TABLE IF NOT EXISTS matches (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL,
    cols INTEGER NOT NULL,
    data BLOB);
CREATE TABLE IF NOT EXISTS two_view_geometries (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL,
    cols INTEGER NOT NULL,
    data BLOB,
    config INTEGER NOT NULL,
    E BLOB, F BLOB, H BLOB, qvec BLOB, tvec BLOB);
""".format(max_id=MAX_IMAGE_ID)


def image_ids_to_pair_id(image_id1: int, image_id2: int) -> int:
    """Symmetric pair key (COLMAP convention: smaller id first)."""
    if image_id1 > image_id2:
        image_id1, image_id2 = image_id2, image_id1
    return image_id1 * MAX_IMAGE_ID + image_id2


def pair_id_to_image_ids(pair_id: int) -> Tuple[int, int]:
    return pair_id // MAX_IMAGE_ID, pair_id % MAX_IMAGE_ID


def array_to_blob(arr: np.ndarray) -> bytes:
    return np.ascontiguousarray(arr).tobytes()


def blob_to_array(blob, dtype, shape) -> np.ndarray:
    if blob is None:
        return np.zeros(shape, dtype)
    return np.frombuffer(blob, dtype).reshape(shape)


class COLMAPDatabase(sqlite3.Connection):
    @staticmethod
    def connect(path: str) -> "COLMAPDatabase":
        return sqlite3.connect(path, factory=COLMAPDatabase)

    def create_tables(self):
        self.executescript(_SCHEMA)

    # -- writers ----------------------------------------------------------
    def add_camera(self, model: int, width: int, height: int,
                   params, prior_focal_length: bool = False,
                   camera_id: Optional[int] = None) -> int:
        params = np.asarray(params, np.float64)
        cur = self.execute(
            "INSERT INTO cameras VALUES (?, ?, ?, ?, ?, ?)",
            (camera_id, model, width, height, array_to_blob(params),
             int(prior_focal_length)),
        )
        return cur.lastrowid

    def add_image(self, name: str, camera_id: int,
                  prior_q=(np.nan,) * 4, prior_t=(np.nan,) * 3,
                  image_id: Optional[int] = None) -> int:
        cur = self.execute(
            "INSERT INTO images VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
            (image_id, name, camera_id, *prior_q, *prior_t),
        )
        return cur.lastrowid

    def add_keypoints(self, image_id: int, keypoints: np.ndarray):
        keypoints = np.asarray(keypoints, np.float32)
        assert keypoints.ndim == 2 and keypoints.shape[1] in (2, 4, 6)
        self.execute(
            "INSERT INTO keypoints VALUES (?, ?, ?, ?)",
            (image_id, *keypoints.shape, array_to_blob(keypoints)),
        )

    def add_descriptors(self, image_id: int, descriptors: np.ndarray):
        descriptors = np.ascontiguousarray(descriptors, np.uint8)
        self.execute(
            "INSERT INTO descriptors VALUES (?, ?, ?, ?)",
            (image_id, *descriptors.shape, array_to_blob(descriptors)),
        )

    def add_matches(self, image_id1: int, image_id2: int,
                    matches: np.ndarray):
        assert matches.ndim == 2 and matches.shape[1] == 2
        if image_id1 > image_id2:
            matches = matches[:, ::-1]
        pair_id = image_ids_to_pair_id(image_id1, image_id2)
        matches = np.asarray(matches, np.uint32)
        self.execute(
            "INSERT INTO matches VALUES (?, ?, ?, ?)",
            (pair_id, *matches.shape, array_to_blob(matches)),
        )

    def add_two_view_geometry(self, image_id1: int, image_id2: int,
                              matches: np.ndarray, F=np.eye(3),
                              E=np.eye(3), H=np.eye(3),
                              qvec=(1.0, 0.0, 0.0, 0.0),
                              tvec=(0.0, 0.0, 0.0), config: int = 2):
        assert matches.ndim == 2 and matches.shape[1] == 2
        if image_id1 > image_id2:
            matches = matches[:, ::-1]
        pair_id = image_ids_to_pair_id(image_id1, image_id2)
        matches = np.asarray(matches, np.uint32)
        self.execute(
            "INSERT INTO two_view_geometries VALUES "
            "(?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
            (pair_id, *matches.shape, array_to_blob(matches), config,
             array_to_blob(np.asarray(F, np.float64)),
             array_to_blob(np.asarray(E, np.float64)),
             array_to_blob(np.asarray(H, np.float64)),
             array_to_blob(np.asarray(qvec, np.float64)),
             array_to_blob(np.asarray(tvec, np.float64))),
        )

    # -- readers ----------------------------------------------------------
    def read_cameras(self) -> Dict[int, dict]:
        out = {}
        for cid, model, w, h, params, prior in self.execute(
                "SELECT * FROM cameras"):
            out[cid] = dict(
                model=model, width=w, height=h,
                params=blob_to_array(params, np.float64, (-1,)),
                prior_focal_length=bool(prior),
            )
        return out

    def read_images(self) -> Dict[int, dict]:
        out = {}
        for row in self.execute("SELECT * FROM images"):
            iid, name, cid = row[0], row[1], row[2]
            out[iid] = dict(name=name, camera_id=cid,
                            prior_q=np.asarray(row[3:7], np.float64),
                            prior_t=np.asarray(row[7:10], np.float64))
        return out

    def read_keypoints(self, image_id: int) -> np.ndarray:
        row = self.execute(
            "SELECT rows, cols, data FROM keypoints WHERE image_id = ?",
            (image_id,)).fetchone()
        if row is None:
            raise KeyError(f"no keypoints for image {image_id}")
        return blob_to_array(row[2], np.float32, (row[0], row[1]))

    def read_descriptors(self, image_id: int) -> np.ndarray:
        row = self.execute(
            "SELECT rows, cols, data FROM descriptors WHERE image_id = ?",
            (image_id,)).fetchone()
        if row is None:
            raise KeyError(f"no descriptors for image {image_id}")
        return blob_to_array(row[2], np.uint8, (row[0], row[1]))

    def read_matches(self, image_id1: int, image_id2: int) -> np.ndarray:
        pair_id = image_ids_to_pair_id(image_id1, image_id2)
        row = self.execute(
            "SELECT rows, cols, data FROM matches WHERE pair_id = ?",
            (pair_id,)).fetchone()
        if row is None:
            raise KeyError(f"no matches for pair ({image_id1},{image_id2})")
        m = blob_to_array(row[2], np.uint32, (row[0], row[1]))
        return m[:, ::-1] if image_id1 > image_id2 else m
