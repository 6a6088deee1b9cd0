"""Map and atlas checkpoints (counterpart of
``orb_slam3_rgbl_tpu.utils.serialization``; reference ``System::SaveAtlas``
/ ``LoadAtlas``, guarded by a checksum of the vocabulary).

The format is the JAX package's, key for key: one compressed ``.npz`` of
the ``MapState`` arrays (prefixed ``m<i>_`` per atlas map), each map's
keyframe-database rows and trajectory segment, and a ``__meta__`` JSON
string. An archive written by either package loads in the other.

The inertial state is written as the JAX package writes it: the
velocity, bias and IMU-chain arrays among the map's arrays, the
``imu_preint`` dict as one id vector and 12 stacked arrays
(``imu_pre_ids``, ``imu_pre_f0`` … ``imu_pre_f11``), and ``imu_initialized``
in the map's meta, so an initialized inertial map of either package loads
in the other. Descriptors stay uint32 on disk. Like the JAX format, an archive keeps no
keyframe-cull redirects (``MapState.kf_redirect``): a frame whose reference
keyframe was culled resolves against that keyframe's last pose after a load.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json

import numpy as np

from orb_slam3_rgbl_tpu_torch.device import resolve
from orb_slam3_rgbl_tpu_torch.retrieval import vocab
from orb_slam3_rgbl_tpu_torch.slam.map_state import MapState

FORMAT_VERSION = 1
_PREINT_FIELDS = 12  # dt dR dV dP JRg JVg JVa JPg JPa cov bg ba


def vocabulary_checksum() -> str:
    """SHA-256 of the LSH vocabulary's definition (the reference's vocabulary
    checksum, ``System::CalculateCheckSum``)."""
    h = hashlib.sha256()
    h.update(vocab.BIT_TABLES.tobytes())
    h.update(np.int64([vocab.N_BANDS, vocab.BITS_PER_BAND]).tobytes())
    return h.hexdigest()


def _array_fields(m: MapState) -> dict:
    return {f.name: getattr(m, f.name) for f in dataclasses.fields(m)
            if isinstance(getattr(m, f.name), np.ndarray)}


def _map_meta(m: MapState) -> dict:
    return {"n_kf": m.n_kf, "n_lm": m.n_lm, "version": m.version, "map_id": m.map_id,
            "imu_initialized": bool(m.imu_initialized)}


def _map_arrays(m: MapState, prefix: str) -> dict:
    arrays = {prefix + k: v for k, v in _array_fields(m).items()}
    # the preintegration chain: the {keyframe: 12 arrays} dict as one id
    # vector and 12 stacked arrays
    ks = sorted(m.imu_preint)
    arrays[prefix + "imu_pre_ids"] = np.asarray(ks, np.int32)
    for j in range(_PREINT_FIELDS):
        arrays[prefix + f"imu_pre_f{j}"] = (
            np.stack([np.asarray(m.imu_preint[k][j]) for k in ks]) if ks
            else np.zeros((0,), np.float32))
    return arrays


def _map_from_arrays(data, prefix: str, meta: dict) -> MapState:
    fields = {f.name for f in dataclasses.fields(MapState)}
    arrays = {k[len(prefix):]: data[k] for k in data.files
              if k.startswith(prefix) and k[len(prefix):] in fields}
    m = MapState(**arrays)
    m.n_kf = int(meta["n_kf"])
    m.n_lm = int(meta["n_lm"])
    m.version = int(meta["version"])
    m.map_id = int(meta["map_id"])
    m.imu_initialized = bool(meta.get("imu_initialized", False))
    m.refresh_free_list()
    ids = data[prefix + "imu_pre_ids"] if prefix + "imu_pre_ids" in data.files else None
    if ids is not None and ids.size:
        cols = [data[prefix + f"imu_pre_f{j}"] for j in range(_PREINT_FIELDS)]
        m.imu_preint = {int(k): tuple(c[i] for c in cols) for i, k in enumerate(ids)}
    return m


def _check_header(meta: dict, path: str, strict_vocab: bool):
    if meta["format_version"] != FORMAT_VERSION:
        raise ValueError(f"{path}: unsupported format {meta['format_version']}")
    if strict_vocab and meta["vocab_checksum"] != vocabulary_checksum():
        raise ValueError(f"{path}: vocabulary checksum mismatch — the archive was built with "
                         "a different retrieval vocabulary")


def save_map(path: str, m: MapState):
    meta = {"format_version": FORMAT_VERSION, **_map_meta(m),
            "vocab_checksum": vocabulary_checksum()}
    np.savez_compressed(path, __meta__=json.dumps(meta), **_array_fields(m))


def load_map(path: str, strict_vocab: bool = True) -> MapState:
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        _check_header(meta, path, strict_vocab)
        return _map_from_arrays(data, "", meta)


def save_atlas(path: str, atlas, tracker=None):
    """Every map of the atlas, its keyframe database (downloaded from the
    device) and its trajectory segment (the active tracker's, archived
    first), guarded by the vocabulary checksum."""
    if tracker is not None:
        atlas.archive_trajectory(tracker)
    arrays, maps_meta = {}, []
    for i, e in enumerate(atlas.entries):
        p = f"m{i}_"
        arrays.update(_map_arrays(e.map, p))
        maps_meta.append({**_map_meta(e.map), "has_db": e.db is not None})
        if e.db is not None:
            arrays[p + "db_vectors"], arrays[p + "db_present"] = e.db.to_numpy()
        arrays[p + "traj_rel"] = (np.stack(e.traj_rel) if e.traj_rel
                                  else np.zeros((0, 7), np.float32))
        arrays[p + "traj_ref_kf"] = np.asarray(e.traj_ref_kf, np.int32)
        arrays[p + "traj_time"] = np.asarray(e.traj_time, np.float64)
        arrays[p + "traj_lost"] = np.asarray(e.traj_lost, bool)
    meta = {"format_version": FORMAT_VERSION, "kind": "atlas",
            "vocab_checksum": vocabulary_checksum(), "n_maps": len(atlas.entries),
            "active_idx": atlas.active_idx, "next_map_id": atlas._next_map_id,
            "n_features": atlas.n_features, "maps": maps_meta}
    np.savez_compressed(path, __meta__=json.dumps(meta), **arrays)


def load_atlas(path: str, config, strict_vocab: bool = True, device=None):
    """Rebuild an ``Atlas`` (maps, keyframe databases on ``device``, default
    ``cuda``, trajectory segments) from a ``save_atlas`` archive of either
    package. A database's word scheme is ``config.vocab_path``'s tree
    vocabulary where one is set, else the LSH words."""
    from orb_slam3_rgbl_tpu_torch.retrieval.keyframe_db import KeyFrameDatabase
    from orb_slam3_rgbl_tpu_torch.retrieval.tree_vocab import TreeVocabulary
    from orb_slam3_rgbl_tpu_torch.slam.atlas import Atlas, AtlasEntry

    device = resolve(device)
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        if meta.get("kind") != "atlas":
            raise ValueError(f"{path}: not an atlas archive (load_map reads single maps)")
        _check_header(meta, path, strict_vocab)
        atlas = Atlas(config, int(meta["n_features"]))
        for i, mm in enumerate(meta["maps"]):
            p = f"m{i}_"
            e = AtlasEntry(map=_map_from_arrays(data, p, mm))
            if mm.get("has_db"):
                voc = (TreeVocabulary.load(config.vocab_path, device=device)
                       if config.vocab_path else None)
                e.db = KeyFrameDatabase.from_numpy(data[p + "db_vectors"], data[p + "db_present"],
                                                   vocabulary=voc, device=device)
            e.traj_rel = [np.array(r, np.float32) for r in data[p + "traj_rel"]]
            e.traj_ref_kf = [int(x) for x in data[p + "traj_ref_kf"]]
            e.traj_time = [float(x) for x in data[p + "traj_time"]]
            e.traj_lost = [bool(x) for x in data[p + "traj_lost"]]
            atlas.entries.append(e)
    atlas.active_idx = int(meta["active_idx"])
    atlas._next_map_id = int(meta["next_map_id"])
    return atlas
