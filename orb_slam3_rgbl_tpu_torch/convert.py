"""Carry configuration and state across from the JAX package.

The system has no weights: what must carry across is its configuration,
the fused step's inter-frame device state, the host map, the tracker's
inter-frame state, the loop closer's, an archived atlas entry with its
keyframe database, and a trained tree vocabulary. Inputs are plain Python (``dataclasses.
asdict`` of a JAX ``SlamConfig``, a JAX ``MapState`` read by attribute)
and numpy arrays, so this module needs nothing of JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from orb_slam3_rgbl_tpu_torch import config as cfg_mod
from orb_slam3_rgbl_tpu_torch.device import resolve
from orb_slam3_rgbl_tpu_torch.geometry.camera import PinholeCamera
from orb_slam3_rgbl_tpu_torch.optim.local_ba import BAProblem
from orb_slam3_rgbl_tpu_torch.optim.pose_graph import PoseGraphProblem
from orb_slam3_rgbl_tpu_torch.retrieval.keyframe_db import KeyFrameDatabase
from orb_slam3_rgbl_tpu_torch.retrieval.tree_vocab import TreeVocabulary
from orb_slam3_rgbl_tpu_torch.slam.atlas import AtlasEntry
from orb_slam3_rgbl_tpu_torch.slam.fast_path import FastPath
from orb_slam3_rgbl_tpu_torch.slam.frame import FrameFeatures
from orb_slam3_rgbl_tpu_torch.slam.map_state import MapState

_NESTED = {"camera": PinholeCamera, "orb": cfg_mod.OrbConfig, "lidar": cfg_mod.LidarConfig,
           "imu": cfg_mod.ImuConfig, "stereo": cfg_mod.StereoConfig}

# FastPath attribute → torch dtype of the port's layout
FAST_PATH_STATE = {
    "prev_uv": torch.float32, "prev_desc": torch.int32, "prev_oct": torch.int32,
    "prev_angle": torch.float32, "prev_Xw": torch.float32, "prev_bound": torch.bool,
    "win_pos": torch.float32, "win_desc": torch.int32, "win_maxdist": torch.float32,
    "win_valid": torch.bool,
}


def _build(cls, d):
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"{cls.__name__}: unknown fields {sorted(unknown)}")
    return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in d.items()})


def config_from_dict(d: dict) -> cfg_mod.SlamConfig:
    """``dataclasses.asdict`` of a JAX ``SlamConfig`` → the port's."""
    d = dict(d)
    for key, cls in _NESTED.items():
        if d.get(key) is not None:
            d[key] = _build(cls, d[key])
    return _build(cfg_mod.SlamConfig, d)


def fast_path_state_from_numpy(fp: FastPath, arrays: dict, device=None) -> FastPath:
    """Load a JAX ``FastPath``'s inter-frame arrays (``prev_*`` and
    ``win_*``, as numpy) into the port's ``FastPath`` on ``device``
    (default: the FastPath's own). uint32 descriptor words keep their bits
    as int32. Returns ``fp``."""
    dev = fp.device if device is None else torch.device(device)
    missing = set(FAST_PATH_STATE) - set(arrays)
    if missing:
        raise ValueError(f"missing FastPath arrays: {sorted(missing)}")
    for name, dtype in FAST_PATH_STATE.items():
        a = np.asarray(arrays[name])
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        ref = getattr(fp, name)
        if a.shape != tuple(ref.shape):
            raise ValueError(f"{name}: shape {a.shape}, FastPath holds {tuple(ref.shape)}")
        setattr(fp, name, torch.as_tensor(np.array(a), dtype=dtype, device=dev))
    return fp


# Tracker attributes that carry one frame's tracking state to the next
TRACKER_STATE = ("cur_pose", "last_pose", "velocity", "ref_kf", "last_lm_idx", "last_lm_gen",
                 "frame_id", "last_kf_frame", "last_reloc_frame")
# ... and those a caller may add: the current frame's bindings, the last
# frame's features (as numpy by field name) and the trajectory log
TRACKER_EXTRA_STATE = ("cur_lm_idx", "last_feats", "traj_rel", "traj_ref_kf", "traj_time",
                       "traj_lost")


def map_state_from_numpy(jax_map) -> MapState:
    """A copy of a JAX ``MapState`` (its numpy arrays, counters, free list
    and cull redirects, read by attribute) as the port's ``MapState``, with
    an allocator lock of its own. Descriptors stay uint32, as the port's
    map keeps them; the inertial state (velocities, biases, the IMU chain
    and its preintegrations, ``imu_initialized``) comes along."""
    kw = {}
    for f in dataclasses.fields(MapState):
        if f.name == "alloc_lock":
            continue
        v = getattr(jax_map, f.name)
        if isinstance(v, np.ndarray):
            v = v.copy()
        elif isinstance(v, (list, dict)):
            v = type(v)(v)
        kw[f.name] = v
    return MapState(**kw)


def ba_problem_from_numpy(arrays: dict, device=None) -> BAProblem:
    """A JAX ``BAProblem`` (as numpy arrays by field name) as the port's,
    on ``device`` (default ``cuda``): floats as float32, ``obs_kf`` as
    int64 indices, masks as bool."""
    dev = resolve(device)
    missing = set(BAProblem._fields) - set(arrays)
    if missing:
        raise ValueError(f"missing BAProblem arrays: {sorted(missing)}")
    dtypes = {"pose_fixed": torch.bool, "pose_valid": torch.bool, "lm_valid": torch.bool,
              "obs_mask": torch.bool, "obs_kf": torch.int64}
    return BAProblem(**{
        name: torch.as_tensor(np.array(arrays[name]), device=dev).to(
            dtypes.get(name, torch.float32))
        for name in BAProblem._fields})


def pose_graph_problem_from_numpy(arrays: dict, device=None) -> PoseGraphProblem:
    """A JAX ``PoseGraphProblem`` (as numpy arrays by field name) as the
    port's, on ``device`` (default ``cuda``): Sim3s and weights as float32,
    edge endpoints as int64 indices, masks as bool. Padded nodes and edges
    (``node_valid`` / ``edge_valid`` False) carry across as they are."""
    dev = resolve(device)
    missing = set(PoseGraphProblem._fields) - set(arrays)
    if missing:
        raise ValueError(f"missing PoseGraphProblem arrays: {sorted(missing)}")
    dtypes = {"node_fixed": torch.bool, "node_valid": torch.bool, "edge_valid": torch.bool,
              "edge_i": torch.int64, "edge_j": torch.int64}
    return PoseGraphProblem(**{
        name: torch.as_tensor(np.array(arrays[name]), device=dev).to(
            dtypes.get(name, torch.float32))
        for name in PoseGraphProblem._fields})


# LoopCloser attributes that carry the plane's state from one keyframe to the next
LOOP_CLOSER_STATE = ("db_vectors", "db_present", "consistent_groups", "extra_edges",
                     "last_loop_kf")


def loop_closer_state_from_numpy(closer, state: dict):
    """Set the port's ``LoopCloser`` to a JAX closer's state, given as plain
    numpy and Python values: ``db_vectors`` (capacity_kf, VOCAB_SIZE) and
    ``db_present`` of its database, ``consistent_groups`` [(set of keyframe
    ids, count)], ``extra_edges`` [(kf_a, kf_b, S_ab (8,), weight)] and
    ``last_loop_kf``. The signatures go to the closer's device. Returns
    ``closer``."""
    missing = set(LOOP_CLOSER_STATE) - set(state)
    if missing:
        raise ValueError(f"missing loop closer state: {sorted(missing)}")
    vectors = np.asarray(state["db_vectors"], np.float32)
    if vectors.shape != tuple(closer.db.vectors.shape):
        raise ValueError(f"db_vectors: shape {vectors.shape}, the database holds "
                         f"{tuple(closer.db.vectors.shape)}")
    closer.db.vectors.copy_(torch.as_tensor(vectors))
    closer.db.present = np.array(state["db_present"], bool)
    closer._consistent_groups = [(set(int(k) for k in g), int(c))
                                 for g, c in state["consistent_groups"]]
    closer.extra_edges = [(int(a), int(b), np.array(S, np.float32), float(w))
                          for a, b, S, w in state["extra_edges"]]
    closer.last_loop_kf = int(state["last_loop_kf"])
    return closer


def tracker_state_from_numpy(tracker, state: dict):
    """Set the ``TRACKER_STATE`` attributes of the port's ``Tracker`` from
    a JAX tracker's values (numpy arrays, ints or None), and those of
    ``TRACKER_EXTRA_STATE`` that ``state`` holds (``last_feats`` as numpy
    by field name, put on the tracker's device). Returns ``tracker``."""
    missing = set(TRACKER_STATE) - set(state)
    if missing:
        raise ValueError(f"missing tracker state: {sorted(missing)}")
    for name in TRACKER_STATE + TRACKER_EXTRA_STATE:
        if name not in state:
            continue
        v = state[name]
        if name == "last_feats":
            v = None if v is None else frame_features_from_numpy(v, tracker.device)
        elif name.startswith("traj_"):
            v = [x.copy() if isinstance(x, np.ndarray) else x for x in v]
        elif isinstance(v, np.ndarray):
            v = v.copy()
        elif v is not None:
            v = int(v)
        setattr(tracker, name, v)
    return tracker


def tree_vocabulary_from_numpy(jax_vocab, device=None) -> TreeVocabulary:
    """A JAX ``TreeVocabulary`` (``k``, uint32 ``levels``, ``idf``, read by
    attribute) as the port's on ``device`` (default ``cuda``): the same
    bits, so the same words and the same ``checksum``."""
    return TreeVocabulary.from_numpy(jax_vocab.k, jax_vocab.levels, jax_vocab.idf, device=device)


def atlas_entry_from_numpy(jax_entry, device=None) -> AtlasEntry:
    """A JAX ``AtlasEntry`` (read by attribute: its map, its keyframe
    database's ``vectors``, ``present`` and vocabulary, and its trajectory
    segment) as the port's, the database on ``device`` (default ``cuda``).
    An entry without a database keeps none."""
    db = None
    if jax_entry.db is not None:
        src = jax_entry.db
        voc = getattr(src, "vocabulary", None)
        db = KeyFrameDatabase.from_numpy(
            np.asarray(src.vectors, np.float32), src.present, device=device,
            vocabulary=None if voc is None else tree_vocabulary_from_numpy(voc, device))
    return AtlasEntry(
        map=map_state_from_numpy(jax_entry.map), db=db,
        traj_rel=[np.array(t, np.float32) for t in jax_entry.traj_rel],
        traj_ref_kf=[int(k) for k in jax_entry.traj_ref_kf],
        traj_time=[float(t) for t in jax_entry.traj_time],
        traj_lost=[bool(x) for x in jax_entry.traj_lost])


def frame_features_from_numpy(arrays: dict, device=None) -> FrameFeatures:
    """A JAX ``FrameFeatures`` (as numpy arrays by field name) as the
    port's, on ``device`` (default ``cuda``); uint32 descriptor words keep their bits as
    int32."""
    dtypes = {"uv": torch.float32, "response": torch.float32, "octave": torch.int32,
              "angle": torch.float32, "desc": torch.int32, "valid": torch.bool,
              "depth": torch.float32, "u_right": torch.float32}
    dev = resolve(device)
    out = {}
    for name, dtype in dtypes.items():
        a = np.asarray(arrays[name])
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        out[name] = torch.as_tensor(np.array(a), dtype=dtype, device=dev)
    return FrameFeatures(**out)
