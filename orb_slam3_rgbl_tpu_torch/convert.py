"""Carry configuration and device state across from the JAX package.

The system has no weights: what must carry across is its configuration
and the fused step's inter-frame device state. Inputs are plain Python
(``dataclasses.asdict`` of a JAX ``SlamConfig``) and numpy arrays, so this
module needs nothing of JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from orb_slam3_rgbl_tpu_torch import config as cfg_mod
from orb_slam3_rgbl_tpu_torch.geometry.camera import PinholeCamera
from orb_slam3_rgbl_tpu_torch.slam.fast_path import FastPath

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
