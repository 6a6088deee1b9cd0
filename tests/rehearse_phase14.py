"""CPU rehearsal of ``chip_smoke.py`` phase 14, for both packages (not a
test: pytest does not collect it).

Writes phase 14's TUM-VI-shaped fisheye sequence at full size, then runs the
port's ``phase14_mode`` on it in both modes with the CUDA calls made no-ops
and one K1 and one K2 counted per extraction (their plain versions run on
the CPU), and, with ``--jax``, the JAX ``System`` over the same files (the
stereo-inertial mode under the reference's inertial rules), reporting its
first OK frame, its IMU initialization's frame and its ATE
(``--no-port``: the JAX ``System`` alone):

    JAX_PLATFORMS=cpu python tests/rehearse_phase14.py [--jax] [--no-port] \\
        [--modes stereo,stereo-inertial] [--workdir DIR] [--reuse]

The bounds of phase 14 (``TUMVI_IMU_INIT_BY``, ``TUMVI_MAX_ATE_M``) come
from these runs (``PERF.md`` §6).
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def rehearse_port(args, cs, cpu):
    from orb_slam3_rgbl_tpu_torch import cuda_build
    from orb_slam3_rgbl_tpu_torch.slam import frame as frame_mod

    for name in ("synchronize", "reset_peak_memory_stats", "set_sync_debug_mode"):
        setattr(torch.cuda, name, lambda *a, **k: None)
    torch.cuda.max_memory_allocated = lambda *a, **k: 0
    extract = frame_mod.extract_features

    def counted(*a, **k):
        for kernel in ("fast_and_blur", "brief_continuous"):
            cuda_build.launch_counts[kernel] += 1
        return extract(*a, **k)

    frame_mod.extract_features = counted
    twc = np.load(os.path.join(args.workdir, "gt.npz"))["twc"]
    for mode in args.modes:
        cs.phase14_mode(mode, *_files(args.workdir), twc, cpu, args.workdir)


def _files(workdir):
    return (os.path.join(workdir, "mav0"), os.path.join(workdir, "timestamps.txt"),
            os.path.join(workdir, "tumvi.yaml"))


def rehearse_jax(args):
    """The JAX ``System`` over the same files; its stereo-inertial drive
    under the reference's inertial rules that the port follows
    (``test_torch_vi_system.reference_rules``)."""
    import contextlib

    import jax
    import jax.numpy as jnp
    from orb_slam3_rgbl_tpu import config as cfg_mod
    from orb_slam3_rgbl_tpu.geometry import align
    from orb_slam3_rgbl_tpu.io.euroc import EurocSequence
    from orb_slam3_rgbl_tpu.slam.system import System

    import chip_smoke as cs

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_torch_vi_system import reference_rules

    twc = np.load(os.path.join(args.workdir, "gt.npz"))["twc"]
    mav, ts_file, settings = _files(args.workdir)
    for mode in args.modes:
        inertial = mode == "stereo-inertial"
        cfg = cfg_mod.load_config(settings, sensor=cfg_mod.IMU_STEREO if inertial
                                  else cfg_mod.STEREO)
        sysm = System(cfg)
        seq = EurocSequence(mav, stereo=True, inertial=inertial, timestamps_file=ts_file)
        n = min(len(seq), cs.TUMVI_MODE_FRAMES[mode])
        init, states, inliers = None, [], []
        with jax.enable_x64(False), reference_rules() if inertial else contextlib.nullcontext():
            for i in range(n):
                fr = seq.frame(i)
                res = sysm.track_stereo(fr[0], fr[1], fr[3], imu=fr[2])
                states.append(res.state)
                inliers.append(res.n_inliers)
                if init is None and sysm.map is not None and sysm.map.imu_initialized:
                    init = i
        first = init if inertial and init is not None else 0
        est = np.asarray(sysm.trajectory())
        with jax.enable_x64(False):
            a = align.horn_align(jnp.asarray(est[first:n, 4:7]), jnp.asarray(twc[first:n, 4:7]))
        print(f"JAX {mode}: first OK frame {states.index(2) if 2 in states else None}, IMU "
              f"initialized on frame {init}, states {sorted(set(states))}, inliers min "
              f"{min(inliers[1:])}, {sysm.map.n_kf} keyframes, SE3-aligned ATE "
              f"{float(a.rmse):.4f} m", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--jax", action="store_true", help="also run the JAX System")
    ap.add_argument("--no-port", action="store_true", help="do not run the port")
    ap.add_argument("--modes", default="stereo,stereo-inertial")
    ap.add_argument("--workdir", default=os.path.join(REPO, "build", "rehearse_phase14"))
    ap.add_argument("--reuse", action="store_true", help="drive the sequence already written")
    args = ap.parse_args()
    args.modes = args.modes.split(",")
    torch.set_num_threads(3)
    import chip_smoke as cs

    cpu = torch.device("cpu")
    if not (args.reuse and os.path.exists(os.path.join(args.workdir, "gt.npz"))):
        times, twc, _, imu_rows, _ = cs.tumvi_motion(cs.N_TUMVI)
        lefts, rights = cs.render_tumvi(twc, cpu)
        shutil.rmtree(args.workdir, ignore_errors=True)
        os.makedirs(args.workdir)
        cs.write_euroc(args.workdir, times, lefts, rights, imu_rows)
        np.savez(os.path.join(args.workdir, "gt.npz"), twc=twc)
        cs.tumvi_settings_yaml(_files(args.workdir)[2])
    if args.jax:
        rehearse_jax(args)
    if not args.no_port:
        rehearse_port(args, cs, cpu)
    print("REHEARSAL OK", flush=True)


if __name__ == "__main__":
    main()
