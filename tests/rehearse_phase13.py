"""CPU rehearsal of ``chip_smoke.py`` phase 13, for both packages (not a
test: pytest does not collect it).

Writes phase 13's EuRoC-shaped sequence at full size, then runs the port's
``phase13_mode`` on it with the CUDA calls made no-ops, the CPU profiler
in place of the card's and one K1 and one K2 counted per extraction (their
plain versions run on the CPU), and, with ``--jax``, the JAX ``System`` over
the same files under the reference's inertial rules, reporting the frames of
its initializations and of VIBA1, its Sim3 scale and its ATE after the IMU
initialization (``--no-port``: the JAX ``System`` alone):

    JAX_PLATFORMS=cpu python tests/rehearse_phase13.py [--jax] [--no-port] \\
        [--frames N] [--modes stereo-inertial,mono-inertial] [--workdir DIR]

About 3 minutes a mode with 3 torch threads for the port, 3 for the JAX
System. The bounds of phase 13 (``IMU_INIT_BY``, the error bounds) come
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
    cs._profile = lambda *a, **k: torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    extract = frame_mod.extract_features

    def counted(*a, **k):
        for kernel in ("fast_and_blur", "brief_continuous"):
            cuda_build.launch_counts[kernel] += 1
        return extract(*a, **k)

    frame_mod.extract_features = counted
    gt = np.load(os.path.join(args.workdir, "gt.npz"))
    for mode in args.modes:
        cs.phase13_mode(mode, *cs.phase13_files(args.workdir, mode), gt["twc"], gt["vel"],
                        gt["g"], cpu, args.workdir)


def rehearse_jax(args):
    """The JAX ``System`` over the same files, under the reference's inertial
    rules that the port follows (``test_torch_vi_system.reference_rules``)."""
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
    for mode in args.modes:
        stereo = mode == "stereo-inertial"
        mav, ts_file, settings = cs.phase13_files(args.workdir, mode)
        cfg = cfg_mod.load_config(settings, sensor=cfg_mod.IMU_STEREO if stereo
                                  else cfg_mod.IMU_MONOCULAR)
        sysm = System(cfg)
        seq = EurocSequence(mav, stereo=stereo, inertial=True, timestamps_file=ts_file)
        init = viba1 = None
        states = []
        n = min(len(seq), args.frames or cs.EUROC_MODE_FRAMES[mode])
        with jax.enable_x64(False), reference_rules():
            for i in range(n):
                fr = seq.frame(i)
                res = (sysm.track_stereo(fr[0], fr[1], fr[3], imu=fr[2]) if stereo
                       else sysm.track_monocular(fr[0], fr[2], imu=fr[1]))
                states.append(res.state)
                if init is None and sysm.map is not None and sysm.map.imu_initialized:
                    init = i
                if viba1 is None and getattr(sysm.mapper, "_viba_stage", 0) >= 1:
                    viba1 = i
            # VIBA1 on the driven state, as phase 13 runs it
            if viba1 is None and getattr(sysm.mapper, "_imu_init_time", None) is not None:
                sysm.mapper.maybe_viba(sysm.mapper._imu_init_time + cs.VIBA1_AFTER_S)
                if getattr(sysm.mapper, "_viba_stage", 0) >= 1:
                    viba1 = "after the drive"
        fit = ""
        if init is not None:
            est = np.asarray(sysm.trajectory())
            e, g = jnp.asarray(est[init:n, 4:7]), jnp.asarray(twc[init:n, 4:7])
            with jax.enable_x64(False):
                a_s, a_r = align.horn_align(e, g, with_scale=True), align.horn_align(e, g)
            fit = f", Sim3 scale {float(a_s.s):.4f}, SE3-aligned ATE {float(a_r.rmse):.4f} m"
        print(f"JAX {mode}: first OK frame {states.index(2) if 2 in states else None}, "
              f"IMU initialized on frame {init}, VIBA1 on frame {viba1}, states after the "
              f"initialization {sorted(set(states[init:])) if init is not None else None}{fit}",
              flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--jax", action="store_true", help="also run the JAX System")
    ap.add_argument("--no-port", action="store_true", help="do not run the port")
    ap.add_argument("--frames", type=int, default=0, help="frames (default N_EUROC)")
    ap.add_argument("--modes", default="stereo-inertial,mono-inertial")
    ap.add_argument("--workdir", default=os.path.join(REPO, "build", "rehearse_phase13"))
    args = ap.parse_args()
    args.modes = args.modes.split(",")
    torch.set_num_threads(3)
    import chip_smoke as cs

    cpu = torch.device("cpu")
    n = args.frames or cs.N_EUROC
    times, twc, vel, imu_rows, g = cs.euroc_motion(n)
    lefts, rights = cs.render_euroc(twc, cpu)
    shutil.rmtree(args.workdir, ignore_errors=True)
    os.makedirs(args.workdir)
    cs.write_euroc(args.workdir, times, lefts, rights, imu_rows)
    np.savez(os.path.join(args.workdir, "gt.npz"), twc=twc, vel=vel, g=g)
    for mode, nf in cs.EUROC_MODES.items():
        cs.euroc_settings_yaml(cs.phase13_files(args.workdir, mode)[2], nf,
                               stereo=mode == "stereo-inertial")
    if args.jax:
        rehearse_jax(args)
    if not args.no_port:
        rehearse_port(args, cs, cpu)
    print("REHEARSAL OK", flush=True)


if __name__ == "__main__":
    main()
