"""The port stands alone: importing it (and ``chip_smoke``) pulls in
neither JAX nor the JAX package; its entry points never fall back to the
CPU on their own; ``chip_smoke.py`` fails without a card or without the
rest of the repository."""

import dataclasses
import operator
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
    "orb_slam3_rgbl_tpu_torch.ops.gba_cuda",
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
    "orb_slam3_rgbl_tpu_torch.io.kitti", "orb_slam3_rgbl_tpu_torch.io.png",
    "orb_slam3_rgbl_tpu_torch.utils", "orb_slam3_rgbl_tpu_torch.utils.serialization",
    "orb_slam3_rgbl_tpu_torch.utils.profiling",
    "orb_slam3_rgbl_tpu_torch.examples.run_kitti_rgbl",
    "orb_slam3_rgbl_tpu_torch.examples.run_kitti_rgbd",
    "orb_slam3_rgbl_tpu_torch.geometry.rectify", "orb_slam3_rgbl_tpu_torch.geometry.two_view",
    "orb_slam3_rgbl_tpu_torch.io.euroc", "orb_slam3_rgbl_tpu_torch.examples.run_kitti_stereo",
    "orb_slam3_rgbl_tpu_torch.examples.run_euroc",
    "orb_slam3_rgbl_tpu_torch.examples.run_tum_rgbd",
    "orb_slam3_rgbl_tpu_torch.imu", "orb_slam3_rgbl_tpu_torch.imu.preintegration",
    "orb_slam3_rgbl_tpu_torch.slam.imu_frontend",
    "orb_slam3_rgbl_tpu_torch.optim.inertial", "orb_slam3_rgbl_tpu_torch.optim.inertial_ba",
    "orb_slam3_rgbl_tpu_torch.utils.logging", "orb_slam3_rgbl_tpu_torch.io.native_loader",
    "orb_slam3_rgbl_tpu_torch.io.online", "orb_slam3_rgbl_tpu_torch.tools",
    "orb_slam3_rgbl_tpu_torch.tools.kitti_publisher",
    "orb_slam3_rgbl_tpu_torch.tools.project_velodyne",
    "orb_slam3_rgbl_tpu_torch.tools.train_vocabulary",
    "orb_slam3_rgbl_tpu_torch.tools.evaluate_ate", "orb_slam3_rgbl_tpu_torch.tools.triage_ate",
    "orb_slam3_rgbl_tpu_torch.tools.pg_probe",
    "orb_slam3_rgbl_tpu_torch.parallel", "orb_slam3_rgbl_tpu_torch.parallel.mesh",
    "orb_slam3_rgbl_tpu_torch.parallel.sharded_ba", "orb_slam3_rgbl_tpu_torch.viz",
    "orb_slam3_rgbl_tpu_torch.viz.raster", "orb_slam3_rgbl_tpu_torch.viz.viewer",
    "orb_slam3_rgbl_tpu_torch.viz.live", "orb_slam3_rgbl_tpu_torch.tools.bench_scaling",
    "orb_slam3_rgbl_tpu_torch.tools.gba_probe", "orb_slam3_rgbl_tpu_torch.tools.map_stage_probe",
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


def test_port_imports_no_opencv_or_pil():
    """The machine with the card has no OpenCV and no PIL: no port module
    imports either, at import time or inside a function."""
    import re

    code = ("import importlib, sys\n"
            f"for m in {PORT_MODULES!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('cv2', 'PIL'))\n"
            "print('LEAKED', bad) if bad else print('CLEAN')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("CLEAN"), out.stdout
    pattern = re.compile(r"^\s*(import|from)\s+(cv2|PIL)\b", re.M)
    sources = [os.path.join(d, f) for d, _, fs in os.walk(os.path.join(REPO, "orb_slam3_rgbl_tpu_torch"))
               for f in fs if f.endswith(".py")] + [os.path.join(REPO, "chip_smoke.py")]
    assert [p for p in sources if pattern.search(open(p).read())] == []


def test_decoder_workers_import_neither_torch_nor_jax():
    """``io/native_loader``'s workers run ``python -m
    orb_slam3_rgbl_tpu_torch.io.native_loader``: the package, ``io/png.py``
    and ``io/kitti.py`` import numpy only."""
    code = ("import importlib, sys\n"
            "importlib.import_module('orb_slam3_rgbl_tpu_torch.io.native_loader')\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'jax', 'cv2'))\n"
            "print('LEAKED', bad) if bad else print('CLEAN')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("CLEAN"), out.stdout


def test_pyproject_lists_every_port_package_and_script():
    """Every directory of the port that holds an ``__init__.py`` is a
    package of the wheel (an installed port imports ``System``, whose
    tracker imports ``orb_slam3_rgbl_tpu_torch.imu``), and every ``-torch``
    console script names a port module with ``main(argv=None)``."""
    import importlib
    import inspect
    import tomllib

    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        project = tomllib.load(f)
    listed = set(project["tool"]["setuptools"]["packages"])
    port = os.path.join(REPO, "orb_slam3_rgbl_tpu_torch")
    found = {os.path.relpath(d, REPO).replace(os.sep, ".") for d, _, files in os.walk(port)
             if "__init__.py" in files}
    assert {"orb_slam3_rgbl_tpu_torch.imu", "orb_slam3_rgbl_tpu_torch.tools"} <= found
    assert found == {p for p in listed if p.split(".")[0] == "orb_slam3_rgbl_tpu_torch"}
    scripts = {k: v for k, v in project["project"]["scripts"].items() if k.endswith("-torch")}
    assert len(scripts) == 14
    for name, target in scripts.items():
        module, func = target.split(":")
        assert module.startswith("orb_slam3_rgbl_tpu_torch."), name
        main = getattr(importlib.import_module(module), func)
        assert list(inspect.signature(main).parameters) == ["argv"], name


def test_entry_points_never_fall_back_to_cpu():
    import numpy as np
    from orb_slam3_rgbl_tpu_torch import device, synthetic
    from orb_slam3_rgbl_tpu_torch.config import MONOCULAR, STEREO, StereoConfig
    from orb_slam3_rgbl_tpu_torch.slam import compiled, frame
    from orb_slam3_rgbl_tpu_torch.slam.system import System

    assert device.resolve("cpu") == torch.device("cpu")
    cfg = synthetic.synthetic_rgbl_config()
    tracking_only = dataclasses.replace(cfg, loop_closing=False)
    img = np.zeros((cfg.camera.height, cfg.camera.width), np.float32)
    cloud = np.zeros((16, 4), np.float32)
    c = cfg.camera
    fisheye_pair = dataclasses.replace(cfg, sensor=STEREO, camera_type="KannalaBrandt8",
                                       stereo=StereoConfig(fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy))
    calls = [lambda: device.resolve(None), lambda: synthetic.make_world(0, tex_size=8),
             lambda: compiled.make_track_step(cfg),
             lambda: frame.extract_features(torch.zeros(64, 64), 64, 64, n_levels=1),
             lambda: System(tracking_only, enable_mapping=False).track_rgbl(img, cloud, 0.0),
             lambda: System(tracking_only).track_rgbl(img, cloud, 0.0),
             lambda: System(cfg).track_rgbl(img, cloud, 0.0),      # the default configuration
             lambda: System(dataclasses.replace(cfg, sensor=STEREO)).track_stereo(img, img, 0.0),
             lambda: System(dataclasses.replace(cfg, sensor=MONOCULAR)).track_monocular(img, 0.0),
             lambda: System(fisheye_pair).track_stereo(img, img, 0.0)]
    for call in calls:
        if torch.cuda.is_available():
            call()
        else:
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                call()
    # the tools with their default --device, on a host without a card (the
    # files need not exist: each resolves the device first)
    from orb_slam3_rgbl_tpu_torch.tools import (bench_scaling, evaluate_ate, gba_probe,
                                                kitti_publisher, map_stage_probe, pg_probe,
                                                project_velodyne, train_vocabulary, triage_ate)
    import tempfile

    import chip_smoke

    settings = os.path.join(tempfile.mkdtemp(), "settings.yaml")
    chip_smoke.settings_yaml(cfg, settings)
    tools = [lambda: evaluate_ate.main(["gt.txt", "est.txt"]), lambda: pg_probe.main([]),
             lambda: project_velodyne.main(["seq"]), lambda: train_vocabulary.main(["images"]),
             lambda: triage_ate.main(["sync", "2"]),
             lambda: kitti_publisher.main([settings, "seq"]),
             lambda: gba_probe.main(["map.npz"]), lambda: map_stage_probe.main(["map.npz"]),
             lambda: bench_scaling.main([])]
    for call in tools if not torch.cuda.is_available() else []:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    # every mode of the fused step is ported; an unknown one is refused
    for mode in compiled.STEP_MODES:
        compiled.make_track_step(cfg, mode=mode, device="cpu")
    with pytest.raises(ValueError, match="unknown mode"):
        compiled.make_track_step(cfg, mode="stereo", device="cpu")


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
    from orb_slam3_rgbl_tpu_torch.config import ImuConfig
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
    from orb_slam3_rgbl_tpu_torch.utils import serialization
    from orb_slam3_rgbl_tpu_torch.parallel import mesh, sharded_ba

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
        pre + "slam.ba_assembly.build_full_vi_problem":
            lambda: ba_assembly.build_full_vi_problem(small_map, np.ones(8, np.float32),
                                                      ImuConfig())[0].Twb,
        pre + "slam.local_mapping.DeviceKfCache.__init__": lambda: DeviceKfCache(4).d_uv,
        pre + "slam.local_mapping.LocalMapper.__init__":
            lambda: LocalMapper(cfg, small_map).dev_cache.d_uv,
        pre + "geometry.lie.sim3_identity": lambda: lie.sim3_identity(),
        pre + "geometry.lie.quat_identity": lambda: lie.quat_identity(),
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
        pre + "utils.serialization.load_atlas":
            lambda: serialization.load_atlas(_tiny_atlas(cfg, small_map), cfg).entries[0].db.vectors,
        pre + "synthetic.synth_gba_problem":
            lambda: synthetic.synth_gba_problem(4, 8, 2, cfg.camera)[0].poses,
        pre + "parallel.mesh.make_mesh": lambda: _one_rank_tensor(mesh),
        pre + "parallel.mesh.rank_layout":
            lambda: torch.zeros(1, device=mesh.rank_layout(1)[1][0]),
        pre + "parallel.mesh.run_ranks": lambda: torch.zeros(
            1, device=mesh.run_ranks(operator.attrgetter("device"), (), 1, timeout_s=120)[0]),
        pre + "parallel.sharded_ba.solve_on_ranks": lambda: sharded_ba.solve_on_ranks(
            [(synthetic.synth_gba_problem(4, 8, 2, cfg.camera, device="cpu")[0], cfg.camera,
              "pcg", dict(iterations=1, cg_iters=2))], 1, timeout_s=120),
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
    assert synthetic.synth_gba_problem(4, 8, 2, cfg.camera, device="cpu")[0].poses.device.type == "cpu"
    assert mesh.rank_layout(2, "cpu") == ("gloo", ["cpu", "cpu"])
    for name, call in calls.items():
        if torch.cuda.is_available():
            out = call()
            if isinstance(out, torch.Tensor):
                assert out.device.type == "cuda", name
        else:
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                call()


def _one_rank_tensor(mesh):
    """A tensor on the device of a one-rank group made with ``device=None``."""
    init, store = mesh.file_store()
    m = mesh.make_mesh(0, 1, "gloo", init)
    try:
        return torch.zeros(1, device=m.device)
    finally:
        m.close()
        shutil.rmtree(store, ignore_errors=True)


def _tiny_atlas(cfg, m) -> str:
    """An atlas archive of one map with its (CPU-built) database."""
    import tempfile

    from orb_slam3_rgbl_tpu_torch.retrieval.keyframe_db import KeyFrameDatabase
    from orb_slam3_rgbl_tpu_torch.slam.atlas import Atlas
    from orb_slam3_rgbl_tpu_torch.utils import serialization

    atlas = Atlas(cfg, m.n_features)
    atlas.create_new_map()
    atlas.entries[0].map = m
    atlas.entries[0].db = KeyFrameDatabase(m.capacity_kf, device="cpu")
    path = os.path.join(tempfile.mkdtemp(), "atlas.npz")
    serialization.save_atlas(path, atlas)
    return path


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
