"""The port stands alone: importing it (and ``chip_smoke``) pulls in
neither JAX nor the JAX package; its entry points never fall back to the
CPU on their own; ``chip_smoke.py`` fails without a card or without the
rest of the repository."""

import dataclasses
import os
import shutil
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_MODULES = [
    "orb_slam3_rgbl_tpu_torch", "orb_slam3_rgbl_tpu_torch.config",
    "orb_slam3_rgbl_tpu_torch.convert", "orb_slam3_rgbl_tpu_torch.cuda_build",
    "orb_slam3_rgbl_tpu_torch.device", "orb_slam3_rgbl_tpu_torch.synthetic",
    "orb_slam3_rgbl_tpu_torch.geometry.camera", "orb_slam3_rgbl_tpu_torch.geometry.lie",
    "orb_slam3_rgbl_tpu_torch.ops.brief_cuda", "orb_slam3_rgbl_tpu_torch.ops.depth",
    "orb_slam3_rgbl_tpu_torch.ops.fast", "orb_slam3_rgbl_tpu_torch.ops.frontend_cuda",
    "orb_slam3_rgbl_tpu_torch.ops.matching", "orb_slam3_rgbl_tpu_torch.ops.orb",
    "orb_slam3_rgbl_tpu_torch.ops.pyramid", "orb_slam3_rgbl_tpu_torch.optim.pose_opt",
    "orb_slam3_rgbl_tpu_torch.slam.compiled", "orb_slam3_rgbl_tpu_torch.slam.fast_path",
    "orb_slam3_rgbl_tpu_torch.slam.frame", "orb_slam3_rgbl_tpu_torch.slam.map_state",
    "orb_slam3_rgbl_tpu_torch.slam.tracking", "orb_slam3_rgbl_tpu_torch.slam.system",
    "orb_slam3_rgbl_tpu_torch.slam.atlas", "orb_slam3_rgbl_tpu_torch.io.trajectory",
    "orb_slam3_rgbl_tpu_torch.geometry.triangulation", "orb_slam3_rgbl_tpu_torch.optim.local_ba",
    "orb_slam3_rgbl_tpu_torch.slam.ba_assembly", "orb_slam3_rgbl_tpu_torch.slam.local_mapping",
    "orb_slam3_rgbl_tpu_torch.retrieval", "orb_slam3_rgbl_tpu_torch.retrieval.vocab",
    "orb_slam3_rgbl_tpu_torch.retrieval.keyframe_db", "orb_slam3_rgbl_tpu_torch.optim.sim3",
    "orb_slam3_rgbl_tpu_torch.optim.pnp", "orb_slam3_rgbl_tpu_torch.optim.pose_graph",
    "orb_slam3_rgbl_tpu_torch.optim.global_ba", "orb_slam3_rgbl_tpu_torch.slam.loop_closing",
    "orb_slam3_rgbl_tpu_torch.geometry.align", "orb_slam3_rgbl_tpu_torch.retrieval.tree_vocab",
    "orb_slam3_rgbl_tpu_torch.slam.merging",
    "chip_smoke",
]


def test_port_and_chip_smoke_import_no_jax():
    code = ("import importlib, sys\n"
            f"for m in {PORT_MODULES!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "             or m.startswith('orb_slam3_rgbl_tpu.') or m == 'orb_slam3_rgbl_tpu')\n"
            "print('LEAKED', bad) if bad else print('CLEAN')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("CLEAN"), out.stdout


def test_entry_points_never_fall_back_to_cpu():
    import numpy as np
    from orb_slam3_rgbl_tpu_torch import device, synthetic
    from orb_slam3_rgbl_tpu_torch.slam import compiled, frame
    from orb_slam3_rgbl_tpu_torch.slam.system import System

    assert device.resolve("cpu") == torch.device("cpu")
    cfg = synthetic.synthetic_rgbl_config()
    tracking_only = dataclasses.replace(cfg, loop_closing=False)
    img = np.zeros((cfg.camera.height, cfg.camera.width), np.float32)
    cloud = np.zeros((16, 4), np.float32)
    calls = [lambda: device.resolve(None), lambda: synthetic.make_world(0, tex_size=8),
             lambda: compiled.make_track_step(cfg),
             lambda: frame.extract_features(torch.zeros(64, 64), 64, 64, n_levels=1),
             lambda: System(tracking_only, enable_mapping=False).track_rgbl(img, cloud, 0.0),
             lambda: System(tracking_only).track_rgbl(img, cloud, 0.0),
             lambda: System(cfg).track_rgbl(img, cloud, 0.0)]      # the default configuration
    for call in calls:
        if torch.cuda.is_available():
            call()
        else:
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                call()
    with pytest.raises(NotImplementedError):
        compiled.make_track_step(cfg, mode="rgbd", device="cpu")


def _functions_with_device_default_none():
    """Every public function or method of the port whose signature has a
    ``device=None`` parameter, as (qualified name, callable)."""
    import importlib
    import inspect

    found = {}
    for name in PORT_MODULES:
        if not name.startswith("orb_slam3_rgbl_tpu_torch."):
            continue
        mod = importlib.import_module(name)
        members = list(vars(mod).items())
        for cls_name, cls in members:
            if inspect.isclass(cls) and cls.__module__ == name:
                members += [(f"{cls_name}.{k}", v) for k, v in vars(cls).items()]
        for attr, fn in members:
            if attr.split(".")[-1].startswith("_") and not attr.endswith("__init__"):
                continue
            if not inspect.isfunction(fn) or fn.__module__ != name:
                continue
            par = inspect.signature(fn).parameters.get("device")
            if par is not None and par.default is None:
                found[f"{name}.{attr}"] = fn
    return found


def test_device_none_never_answers_on_the_cpu():
    """The rule for ``device=None``: it means the card (``device.resolve``).
    Each such function either resolves it (so on a host without a card the
    call raises, and with one the result lies on it) or, where it takes an
    object that already lives on a device, follows that object."""
    import types

    import numpy as np
    from orb_slam3_rgbl_tpu_torch import convert, device, synthetic
    from orb_slam3_rgbl_tpu_torch.geometry import camera, lie
    from orb_slam3_rgbl_tpu_torch.retrieval import tree_vocab, vocab
    from orb_slam3_rgbl_tpu_torch.slam import merging
    from orb_slam3_rgbl_tpu_torch.optim.local_ba import BAProblem
    from orb_slam3_rgbl_tpu_torch.slam import ba_assembly, compiled, frame
    from orb_slam3_rgbl_tpu_torch.slam.fast_path import FastPath
    from orb_slam3_rgbl_tpu_torch.optim.pose_graph import PoseGraphProblem
    from orb_slam3_rgbl_tpu_torch.retrieval.keyframe_db import KeyFrameDatabase
    from orb_slam3_rgbl_tpu_torch.slam.local_mapping import DeviceKfCache, LocalMapper
    from orb_slam3_rgbl_tpu_torch.slam.loop_closing import LoopCloser
    from orb_slam3_rgbl_tpu_torch.slam.map_state import MapState
    from orb_slam3_rgbl_tpu_torch.slam.system import System
    from orb_slam3_rgbl_tpu_torch.slam.tracking import Tracker

    cfg = dataclasses.replace(synthetic.synthetic_rgbl_config(), loop_closing=False)
    feats = {k: np.zeros((4,) + s, d) for k, s, d in (
        ("uv", (2,), np.float32), ("response", (), np.float32), ("octave", (), np.int32),
        ("angle", (), np.float32), ("desc", (8,), np.uint32), ("valid", (), bool),
        ("depth", (), np.float32), ("u_right", (), np.float32))}
    ba = {name: np.zeros((2, 3, 7)[: 1 + (name in ("poses", "landmarks", "obs_uv", "obs_kf"))])
          for name in BAProblem._fields}
    pg = {name: np.zeros((2, 8) if name in ("nodes", "edge_Sij") else (2,))
          for name in PoseGraphProblem._fields}
    small_map = MapState.create(2, 8, 4)
    descs = np.arange(32, dtype=np.uint32).reshape(4, 8)
    jax_vocab = types.SimpleNamespace(k=2, levels=[np.zeros((2, 8), np.uint32)],
                                      idf=np.ones(2, np.float32))
    jax_entry = types.SimpleNamespace(
        map=small_map, traj_rel=[], traj_ref_kf=[], traj_time=[], traj_lost=[],
        db=types.SimpleNamespace(vectors=np.zeros((2, vocab.VOCAB_SIZE), np.float32),
                                 present=np.zeros(2, bool), vocabulary=None))
    pre = "orb_slam3_rgbl_tpu_torch."
    calls = {
        pre + "device.resolve": lambda: device.resolve(),
        pre + "geometry.lie.se3_identity": lambda: lie.se3_identity(),
        pre + "slam.frame.scale_sigma2": lambda: frame.scale_sigma2(),
        pre + "slam.frame.inv_scale_sigma2": lambda: frame.inv_scale_sigma2(),
        pre + "slam.frame.extract_features":
            lambda: frame.extract_features(torch.zeros(64, 64), 64, 64, n_levels=1).uv,
        pre + "slam.compiled.make_frame_step": lambda: compiled.make_frame_step(cfg),
        pre + "slam.compiled.make_track_step": lambda: compiled.make_track_step(cfg),
        pre + "slam.compiled.example_inputs": lambda: compiled.example_inputs(cfg, n_points=64)[0],
        pre + "slam.system.System.__init__": lambda: System(cfg, enable_mapping=False),
        pre + "slam.tracking.Tracker.__init__": lambda: Tracker(cfg, None),
        pre + "slam.fast_path.FastPath.__init__": lambda: FastPath(cfg, 64),
        pre + "synthetic.make_world": lambda: synthetic.make_world(0, tex_size=8).tex,
        pre + "convert.frame_features_from_numpy":
            lambda: convert.frame_features_from_numpy(feats).uv,
        pre + "convert.ba_problem_from_numpy": lambda: convert.ba_problem_from_numpy(ba).poses,
        pre + "geometry.camera.intrinsics": lambda: camera.intrinsics(cfg.camera),
        pre + "slam.ba_assembly.build_full_problem":
            lambda: ba_assembly.build_full_problem(small_map, np.ones(8, np.float32))[0].poses,
        pre + "slam.local_mapping.DeviceKfCache.__init__": lambda: DeviceKfCache(4).d_uv,
        pre + "slam.local_mapping.LocalMapper.__init__":
            lambda: LocalMapper(cfg, small_map).dev_cache.d_uv,
        pre + "geometry.lie.sim3_identity": lambda: lie.sim3_identity(),
        pre + "synthetic.make_box_world": lambda: synthetic.make_box_world(0, tex_size=8).tex,
        pre + "convert.pose_graph_problem_from_numpy":
            lambda: convert.pose_graph_problem_from_numpy(pg).nodes,
        pre + "retrieval.keyframe_db.KeyFrameDatabase.__init__":
            lambda: KeyFrameDatabase(4).vectors,
        pre + "slam.loop_closing.LoopCloser.__init__":
            lambda: LoopCloser(cfg, small_map).db.vectors,
        pre + "retrieval.tree_vocab.train_vocabulary":
            lambda: tree_vocab.train_vocabulary(descs, k=2, depth=1).idf,
        pre + "slam.merging.verify_cross_map":
            lambda: merging.verify_cross_map(cfg, small_map, 0, small_map, 0, True),
        pre + "convert.tree_vocabulary_from_numpy":
            lambda: convert.tree_vocabulary_from_numpy(jax_vocab).idf,
        pre + "convert.atlas_entry_from_numpy":
            lambda: convert.atlas_entry_from_numpy(jax_entry).db.vectors,
    }
    # follows the FastPath it is given: covered by tests/test_torch_step.py
    follows_an_object = {pre + "convert.fast_path_state_from_numpy"}
    assert set(_functions_with_device_default_none()) == set(calls) | follows_an_object
    assert lie.se3_identity(device="cpu").device.type == "cpu"
    assert frame.inv_scale_sigma2(device="cpu").device.type == "cpu"
    assert camera.intrinsics(cfg.camera, device="cpu").device.type == "cpu"
    assert DeviceKfCache(4, device="cpu").d_desc.device.type == "cpu"
    assert lie.sim3_identity(device="cpu").device.type == "cpu"
    assert KeyFrameDatabase(4, device="cpu").vectors.device.type == "cpu"
    assert LoopCloser(cfg, small_map, device="cpu").db.vectors.device.type == "cpu"
    assert tree_vocab.train_vocabulary(descs, k=2, depth=1, device="cpu").idf.device.type == "cpu"
    assert convert.atlas_entry_from_numpy(jax_entry, device="cpu").db.vectors.device.type == "cpu"
    for name, call in calls.items():
        if torch.cuda.is_available():
            out = call()
            if isinstance(out, torch.Tensor):
                assert out.device.type == "cuda", name
        else:
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                call()


def test_chip_smoke_fails_without_card_or_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run for real")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout
