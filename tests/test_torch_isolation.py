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
             lambda: System(tracking_only, enable_mapping=False).track_rgbl(img, cloud, 0.0)]
    for call in calls:
        if torch.cuda.is_available():
            call()
        else:
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                call()
    with pytest.raises(NotImplementedError):
        compiled.make_track_step(cfg, mode="rgbd", device="cpu")


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
