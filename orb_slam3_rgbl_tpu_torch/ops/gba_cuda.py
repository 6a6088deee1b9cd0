"""The CG step of the whole-map bundle adjustment (``optim/global_ba``) as
hand-written CUDA kernels (``csrc/gba.cu``): the observation half of H·v
with its pose sums, the block-Jacobi preconditioner's apply, and the step's
vector updates around it.

They replace no Pallas kernel: the JAX package leaves these products to XLA,
and the port ran them as ``torch.einsum``, which cuBLAS turns into one
batched gemv per (M, D) slot. ``HessianProduct`` launches ``gba_hv`` (the
slots of each landmark together, masked slots' Jacobians not read; the
landmark half finished in the same pass) and ``gba_pose_sum`` (each pose's
slot partials added in the order of its ``PoseSegments`` row; also the
landmark half of the dot product). ``BlockJacobi`` launches
``gba_cg_update``: for a step's iterate, residual and preconditioned residual
together, and (called on a vector) for the apply alone, once a linearization;
``cg_direction`` launches ``gba_cg_direction``. No atomics: two calls on the
same inputs give the same bits.

The plain versions (``hv_plain``, ``precond_plain``, ``cg_update_plain``,
``cg_direction_plain``) are the PyTorch code the solver ran before; the
wrappers take them only for tensors on the CPU. For CUDA tensors they launch
the kernels or raise. The wrappers check their fixed operands once, when
made (once a linearization), and the vectors at every call.

The whole-map inertial solve (``optim/global_inertial_ba``) runs them on
15-wide states [pose(6), vel(3), bg(3), ba(3)]: ``HessianProduct`` takes a
(K, 15) vector and reads its pose columns 0:6, ``BlockJacobi`` takes
(K, 15, 15) blocks, ``cg_direction`` a (K, 15) half; and ``PairProduct``
launches ``gba_pair_hv``, the inertial pairs' half of H·v with the visual
pose sums, the damping, the state mask and the dot product v·H·v in one
block (``pair_hv_plain`` its plain version, the same bits).

The visual solve's LM iteration outside CG runs here too, on the card
alone: ``linearize`` launches ``gba_linearize`` (each slot's residual,
weight, cost and Jacobians, landmark-major; the landmark gradient and
diagonal blocks summed in slot order in the same pass) and
``gba_pose_blocks`` (each pose's gradient and diagonal block from its live
slots in ``PoseSegments`` order, and the cost summed from the first pass's
block partials); ``cost`` launches the same two kernels without the
Jacobians and the poses (the accept test's cost and active count, through
the same per-slot routine and the same order of sums, so a cost and the cost
of the step after it compare rounded alike); ``apply_step`` launches
``gba_apply_step`` (the step's pose and landmark update; on the CPU its
plain version ``apply_step_plain``). The plain versions of ``linearize`` and
``cost`` are the solver's own (``optim/global_ba``), which the CPU runs.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from orb_slam3_rgbl_tpu_torch import cuda_build
from orb_slam3_rgbl_tpu_torch.geometry import lie
from orb_slam3_rgbl_tpu_torch.geometry.camera import is_fisheye

THREADS = 256          # csrc/gba.cu THREADS: threads of a block, slots of an H·v tile
MAX_D = THREADS        # csrc/gba.cu MAX_D: most observation slots a landmark
PAIR_THREADS = 1024    # csrc/gba.cu PAIR_THREADS: threads of the one gba_pair_hv block
WIDTHS = (6, 15)       # pose blocks of the visual solve, states of the inertial one
PINHOLE, PINHOLE_DISTORTED, KB8 = 0, 1, 2     # csrc/gba.cu's camera models


def hv_plain(Jp, Jl, w, obs_kf, segments, v_p, v_l, lam_l, lm_free):
    """This rank's pose sums of Jpᵀ·w·J·v (K, 6), the landmark half of H·v,
    (Jlᵀ·w·J·v + lam_l·v_l)·lm_free (M, 3), and its share v_l·Hv_l of the
    dot product v·H·v. ``segments``: the ``PoseSegments`` of ``obs_kf``;
    ``v_p`` (K, 6), or (K, 15) states whose columns 0:6 are the poses."""
    Jv = (torch.einsum("mdij,mdj->mdi", Jp, v_p[:, :6][obs_kf])
          + torch.einsum("mdij,mj->mdi", Jl, v_l))
    wJv = w[..., None] * Jv
    Hl = torch.einsum("mdij,mdi->mj", Jl, wJv)
    Hv_l = (Hl + lam_l * v_l) * lm_free
    Hp = segments.sum(torch.einsum("mdij,mdi->mdj", Jp, wJv))
    return Hp, Hv_l, torch.sum(v_l * Hv_l)


def precond_plain(Minv_p, Minv_l, v_p, v_l, pose_free, lm_free):
    """The block-Jacobi apply: (Minv_p·v_p·pose_free, Minv_l·v_l·lm_free)."""
    return (torch.einsum("kij,kj->ki", Minv_p, v_p) * pose_free,
            torch.einsum("mij,mj->mi", Minv_l, v_l) * lm_free)


def cg_update_plain(precond, rz, pAp, x, rr, p, Ap):
    """A CG step's update before its dot product: alpha = rz / pAp, the
    iterate x + alpha·p, the residual rr − alpha·Ap, and ``precond`` of the
    new residual. Each argument but the scalars is a (pose, landmark) pair."""
    alpha = rz / pAp.clamp_min(1e-20)
    x = (x[0] + alpha * p[0], x[1] + alpha * p[1])
    rr = (rr[0] - alpha * Ap[0], rr[1] - alpha * Ap[1])
    return x, rr, precond(*rr)


def cg_direction_plain(rz_new, rz, z, p):
    """The next search direction z + beta·p, beta = rz_new / rz."""
    beta = rz_new / rz.clamp_min(1e-20)
    return (z[0] + beta * p[0], z[1] + beta * p[1])


def pair_hv_plain(Hp, J, w, pair_i, pair_j, table, v, lam, state_free, lm_half):
    """The 15-wide states' half of H·v and the dot product v·H·v, in the
    order ``gba_pair_hv`` adds them (the same bits): u = w·(J₁·v_i + J₂·v_j)
    for each pair (J (P, 15, 30), w (P, 15)); each state's Hp (K, 6) in
    columns 0:6, plus J_sideᵀ·u of each entry of its row of ``table``
    (K, Lp) of 2·pair + side in order (an entry outside [0, 2P) adds
    nothing), plus lam·v, times ``state_free`` (K, 1); then
    Σ v·Hv (each of ``PAIR_THREADS`` threads its strided outputs in order, a
    shuffle tree in each warp, the warps in order) + ``lm_half``. Returns
    (Hv (K, 15), pAp ())."""
    K, S = v.shape
    P = J.shape[0]
    x = torch.cat([v[pair_i], v[pair_j]], dim=-1)                       # (P, 30)
    a = torch.zeros(J.shape[:2], dtype=v.dtype, device=v.device)
    for c in range(2 * S):
        a = a + J[:, :, c] * x[:, c:c + 1]
    u = w * a                                                           # (P, 15)
    # each entry's J_sideᵀ·u, the rows added in order; a zero row for the rest
    Js = J.reshape(P, S, 2, S).permute(0, 2, 1, 3).reshape(2 * P, S, S)  # (2P, 15 rows, 15)
    us = u.repeat_interleave(2, dim=0)                                  # (2P, 15)
    h = torch.zeros((2 * P + 1, S), dtype=v.dtype, device=v.device)
    hp = torch.zeros((2 * P, S), dtype=v.dtype, device=v.device)
    for r in range(S):
        hp = hp + Js[:, r, :] * us[:, r:r + 1]
    h[:2 * P] = hp
    valid = (table >= 0) & (table < 2 * P)
    idx = torch.where(valid, table, 2 * P)
    acc = torch.nn.functional.pad(Hp, (0, S - Hp.shape[1]))
    for col in range(table.shape[1]):
        acc = torch.where(valid[:, col:col + 1], acc + h[idx[:, col]], acc)
    Hv = (acc + lam * v) * state_free.to(v.dtype)
    # the dot product in the kernel's order
    prod = (v * Hv).reshape(-1)
    n = prod.numel()
    rounds = -(-n // PAIR_THREADS)
    lanes = torch.zeros(rounds * PAIR_THREADS, dtype=v.dtype, device=v.device)
    lanes[:n] = prod
    lanes = lanes.reshape(rounds, PAIR_THREADS)
    d = torch.zeros(PAIR_THREADS, dtype=v.dtype, device=v.device)
    for i in range(rounds):
        d = d + lanes[i]
    d = d.reshape(PAIR_THREADS // 32, 32)
    for o in (16, 8, 4, 2, 1):
        d = d[:, :o] + d[:, o:2 * o]
    total = torch.zeros((), dtype=v.dtype, device=v.device)
    for i in range(PAIR_THREADS // 32):
        total = total + d[i, 0]
    return Hv, total + lm_half.reshape(())


def landmarks_per_block(D: int) -> int:
    """Landmarks of one ``gba_hv`` block: as many whole landmarks of D slots
    as fit in its 256, cut where that lets every block's stretch of the
    Jacobians start on 16 bytes (landmarks × D a multiple of 4)."""
    if not 1 <= D <= MAX_D:
        raise ValueError(f"gba_hv: takes 1 to {MAX_D} observation slots a landmark, got {D}")
    most = THREADS // D
    return next((n for n in range(most, 0, -1) if n * D % 4 == 0), most)


@functools.lru_cache(maxsize=None)
def _kernels() -> dict:
    lib = cuda_build.library("gba")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fp = ctypes.POINTER(ctypes.c_float)
    fns = {"hv": (lib.gba_hv_f32, [p] * 11 + [i] * 5 + [p]),
           "pose_sum": (lib.gba_pose_sum_f32, [p] * 3 + [i, i, ll, p, i, p, p, p]),
           "update": (lib.gba_cg_update_f32, [p] * 20 + [i, i, i, p]),
           "direction": (lib.gba_cg_direction_f32, [p] * 8 + [i, i, i, p]),
           "pair_hv": (lib.gba_pair_hv_f32, [p] * 13 + [i] * 3 + [p]),
           "linearize": (lib.gba_linearize_f32, [p] * 10 + [fp] + [i] * 7 + [p] * 10 + [p]),
           "pose_blocks": (lib.gba_pose_blocks_f32, [p] * 4 + [i, i, ll] + [p] * 2 + [i]
                           + [p] * 4 + [p]),
           "apply_step": (lib.gba_apply_step_f32, [p] * 6 + [i, i, p])}
    for fn, argtypes in fns.values():
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return {k: fn for k, (fn, _) in fns.items()}


def _width(t: torch.Tensor) -> int:
    """The row width of a pose (6) or inertial state (15) half, or of its
    preconditioner blocks; 6 for any other shape, which the checks refuse."""
    return t.shape[-1] if t.dim() in (2, 3) and t.shape[-1] in WIDTHS else 6


def _check(fn_name: str, name: str, t: torch.Tensor, dtype, shape, device):
    if (t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous()
            or t.device != device):
        raise ValueError(f"{fn_name}: {name} must be a contiguous {dtype} {shape} tensor on "
                         f"{device}, got {tuple(t.shape)} {t.dtype} on {t.device}"
                         + ("" if t.is_contiguous() else " (not contiguous)"))


def _device(fn_name: str, t: torch.Tensor) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"{fn_name}: unsupported device {t.device}")
    return t.device


def _raise_on(fn_name: str, err: int):
    if err != 0:
        raise RuntimeError(f"{fn_name}: kernel launch failed (cudaError {err})")


def _check_pairs(fn_name: str, dev, K: int, M: int, width: int = 6, **pairs):
    """Each (pose, landmark) pair: contiguous float32 (K, width) and (M, 3) on
    ``dev``."""
    for name, (a, b) in pairs.items():
        _check(fn_name, name + "[0]", a, torch.float32, (K, width), dev)
        _check(fn_name, name + "[1]", b, torch.float32, (M, 3), dev)


def _check_scalars(fn_name: str, dev, **scalars):
    """Each a float32 value on ``dev``: shape () or, from an ``all_reduce``'d
    buffer, (1,)."""
    for name, t in scalars.items():
        _check(fn_name, name, t, torch.float32, tuple(t.shape) if t.numel() == 1 else (), dev)


def _pair(dev, K: int, M: int, width: int = 6):
    return (torch.empty((K, width), dtype=torch.float32, device=dev),
            torch.empty((M, 3), dtype=torch.float32, device=dev))


class HessianProduct:
    """v ↦ ``hv_plain``'s three values for one linearization: Jacobians
    ``Jp`` (M, D, 3, 6), ``Jl`` (M, D, 3, 3), weights ``w`` (M, D) and keyframe
    indices ``obs_kf`` (M, D); ``segments`` the ``PoseSegments`` of
    ``obs_kf``; ``lam_l`` (M, 3) the landmark damping, ``lm_free`` (M, 1)
    bool. On the card: float32, int64 indices, contiguous; the calls share
    scratch buffers, so they run on one stream."""

    def __init__(self, Jp, Jl, w, obs_kf, segments, lam_l, lm_free):
        self.args = (Jp, Jl, w, obs_kf, segments, lam_l, lm_free)
        if Jp.device.type == "cpu":
            return
        fn = "gba_hv"
        dev = _device(fn, Jp)
        M, D = obs_kf.shape
        self.lpb = landmarks_per_block(D)
        f32 = torch.float32
        for name, t, dtype, shape in (
                ("Jp", Jp, f32, (M, D, 3, 6)), ("Jl", Jl, f32, (M, D, 3, 3)),
                ("w", w, f32, (M, D)), ("obs_kf", obs_kf, torch.int64, (M, D)),
                ("lam_l", lam_l, f32, (M, 3)), ("lm_free", lm_free, torch.bool, (M, 1))):
            _check(fn, name, t, dtype, shape, dev)
        K, L = segments.table.shape
        _check(fn, "segments.table", segments.table, torch.int64, (K, L), dev)
        if segments.n_obs != M * D:
            raise ValueError(f"{fn}: segments of {segments.n_obs} slots for a ({M}, {D}) table")
        self.dev, self.M, self.D, self.K, self.L = dev, M, D, K, L
        self.nb = max(1, -(-M // self.lpb))
        # scratch of every call, reused in stream order: the slots' pose
        # partials (read where w != 0) and the blocks' dot partials
        self.part = torch.empty((M * D, 6), dtype=torch.float32, device=dev)
        self.dot_part = torch.empty((self.nb,), dtype=torch.float32, device=dev)

    def __call__(self, v_p: torch.Tensor, v_l: torch.Tensor):
        Jp, Jl, w, obs_kf, segments, lam_l, lm_free = self.args
        if Jp.device.type == "cpu":
            return hv_plain(Jp, Jl, w, obs_kf, segments, v_p, v_l, lam_l, lm_free)
        fn, dev, M, D, K = "gba_hv", self.dev, self.M, self.D, self.K
        width = _width(v_p)
        _check_pairs(fn, dev, K, M, width, v=(v_p, v_l))
        Hv_l = torch.empty((M, 3), dtype=torch.float32, device=dev)
        Hp = torch.empty((K, 6), dtype=torch.float32, device=dev)
        lm_half = torch.empty((), dtype=torch.float32, device=dev)
        k = _kernels()
        hv, pose_sum = k["hv"], k["pose_sum"]
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            _raise_on(fn, hv(Jp.data_ptr(), Jl.data_ptr(), w.data_ptr(), obs_kf.data_ptr(),
                             v_p.data_ptr(), v_l.data_ptr(), lam_l.data_ptr(),
                             lm_free.data_ptr(), Hv_l.data_ptr(), self.part.data_ptr(),
                             self.dot_part.data_ptr(), M, D, self.lpb, self.nb, width, stream))
            cuda_build.launch_counts["gba_hv"] += 1
            _raise_on("gba_pose_sum", pose_sum(
                self.part.data_ptr(), w.data_ptr(), segments.table.data_ptr(), K, self.L, M * D,
                self.dot_part.data_ptr(), self.nb, Hp.data_ptr(), lm_half.data_ptr(), stream))
            cuda_build.launch_counts["gba_pose_sum"] += 1
        return Hp, Hv_l, lm_half


class BlockJacobi:
    """v ↦ ``precond_plain``'s pair for the inverted diagonal blocks
    ``Minv_p`` (K, 6, 6), or (K, 15, 15) for inertial states, and ``Minv_l``
    (M, 3, 3), masks ``pose_free`` (K, 1) and ``lm_free`` (M, 1) bool. On
    the card: float32, contiguous."""

    def __init__(self, Minv_p, Minv_l, pose_free, lm_free):
        self.args = (Minv_p, Minv_l, pose_free, lm_free)
        if Minv_p.device.type == "cpu":
            return
        fn = "gba_cg_update"
        dev = _device(fn, Minv_p)
        K, M = Minv_p.shape[0], Minv_l.shape[0]
        W = _width(Minv_p)
        for name, t, dtype, shape in (
                ("Minv_p", Minv_p, torch.float32, (K, W, W)),
                ("Minv_l", Minv_l, torch.float32, (M, 3, 3)),
                ("pose_free", pose_free, torch.bool, (K, 1)),
                ("lm_free", lm_free, torch.bool, (M, 1))):
            _check(fn, name, t, dtype, shape, dev)
        self.dev, self.K, self.M, self.W = dev, K, M, W
        self.ptrs = (Minv_p.data_ptr(), Minv_l.data_ptr(), pose_free.data_ptr(),
                     lm_free.data_ptr())

    def __call__(self, v_p: torch.Tensor, v_l: torch.Tensor):
        Minv_p, Minv_l, pose_free, lm_free = self.args
        if Minv_p.device.type == "cpu":
            return precond_plain(Minv_p, Minv_l, v_p, v_l, pose_free, lm_free)
        fn, dev, K, M, W = "gba_cg_update", self.dev, self.K, self.M, self.W
        _check_pairs(fn, dev, K, M, W, v=(v_p, v_l))
        z_p, z_l = _pair(dev, K, M, W)
        # the apply alone: the step's scalars and vectors null, v in the residual's place
        with torch.cuda.device(dev):
            _raise_on(fn, _kernels()["update"](
                *self.ptrs, None, None, None, None, v_p.data_ptr(), v_l.data_ptr(),
                *[None] * 8, z_p.data_ptr(), z_l.data_ptr(), K, M, W,
                torch.cuda.current_stream(dev).cuda_stream))
        cuda_build.launch_counts["gba_cg_update"] += 1
        return z_p, z_l

    def update(self, rz, pAp, x, rr, p, Ap):
        """``cg_update_plain`` with this preconditioner: on the card one
        launch of ``gba_cg_update`` (the same bits as the separate
        operations and this preconditioner's apply)."""
        Minv_p = self.args[0]
        if Minv_p.device.type == "cpu":
            return cg_update_plain(self, rz, pAp, x, rr, p, Ap)
        fn, dev, K, M, W = "gba_cg_update", self.dev, self.K, self.M, self.W
        _check_scalars(fn, dev, rz=rz, pAp=pAp)
        _check_pairs(fn, dev, K, M, W, x=x, rr=rr, p=p, Ap=Ap)
        xo, ro, z = _pair(dev, K, M, W), _pair(dev, K, M, W), _pair(dev, K, M, W)
        with torch.cuda.device(dev):
            _raise_on(fn, _kernels()["update"](
                *self.ptrs, rz.data_ptr(), pAp.data_ptr(),
                *(t.data_ptr() for pair in (x, rr, p, Ap, xo, ro, z) for t in pair), K, M, W,
                torch.cuda.current_stream(dev).cuda_stream))
        cuda_build.launch_counts["gba_cg_update"] += 1
        return xo, ro, z


def cg_direction(rz_new, rz, z, p):
    """``cg_direction_plain``; on the card one launch of
    ``gba_cg_direction`` (the same bits as the separate operations)."""
    if z[0].device.type == "cpu":
        return cg_direction_plain(rz_new, rz, z, p)
    fn = "gba_cg_direction"
    dev = _device(fn, z[0])
    K, M = z[0].shape[0], z[1].shape[0]
    W = _width(z[0])
    _check_scalars(fn, dev, rz_new=rz_new, rz=rz)
    _check_pairs(fn, dev, K, M, W, z=z, p=p)
    po = _pair(dev, K, M, W)
    with torch.cuda.device(dev):
        _raise_on(fn, _kernels()["direction"](
            rz_new.data_ptr(), rz.data_ptr(), *(t.data_ptr() for pair in (z, p, po) for t in pair),
            K, M, W, torch.cuda.current_stream(dev).cuda_stream))
    cuda_build.launch_counts["gba_cg_direction"] += 1
    return po


class PairProduct:
    """(Hp, v, lm_half) ↦ ``pair_hv_plain``'s (Hv, pAp) for one
    linearization of the inertial pairs: Jacobians ``J`` (P, 15, 30),
    weights ``w`` (P, 15), endpoints ``pair_i`` / ``pair_j`` (P,) int64, the
    sorted pair table ``table`` (K, Lp) int64, the damping ``lam`` (K, 15)
    and ``state_free`` (K, 1) bool. On the card: float32, contiguous, one
    launch of ``gba_pair_hv`` a call."""

    def __init__(self, J, w, pair_i, pair_j, table, lam, state_free):
        self.args = (J, w, pair_i, pair_j, table, lam, state_free)
        if J.device.type == "cpu":
            return
        fn = "gba_pair_hv"
        dev = _device(fn, J)
        P, (K, Lp) = J.shape[0], table.shape
        for name, t, dtype, shape in (
                ("J", J, torch.float32, (P, 15, 30)), ("w", w, torch.float32, (P, 15)),
                ("pair_i", pair_i, torch.int64, (P,)), ("pair_j", pair_j, torch.int64, (P,)),
                ("table", table, torch.int64, (K, Lp)), ("lam", lam, torch.float32, (K, 15)),
                ("state_free", state_free, torch.bool, (K, 1))):
            _check(fn, name, t, dtype, shape, dev)
        if Lp < 1:
            raise ValueError(f"{fn}: the pair table needs a column, got {tuple(table.shape)}")
        self.dev, self.K, self.P, self.Lp = dev, K, P, Lp
        self.u = torch.empty((max(P, 1), 15), dtype=torch.float32, device=dev)   # scratch

    def __call__(self, Hp: torch.Tensor, v: torch.Tensor, lm_half: torch.Tensor):
        J, w, pair_i, pair_j, table, lam, state_free = self.args
        if J.device.type == "cpu":
            return pair_hv_plain(Hp, J, w, pair_i, pair_j, table, v, lam, state_free, lm_half)
        fn, dev, K = "gba_pair_hv", self.dev, self.K
        _check(fn, "Hp", Hp, torch.float32, (K, 6), dev)
        _check(fn, "v", v, torch.float32, (K, 15), dev)
        _check_scalars(fn, dev, lm_half=lm_half)
        Hv = torch.empty((K, 15), dtype=torch.float32, device=dev)
        pAp = torch.empty((), dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            _raise_on(fn, _kernels()["pair_hv"](
                Hp.data_ptr(), J.data_ptr(), w.data_ptr(), pair_i.data_ptr(), pair_j.data_ptr(),
                table.data_ptr(), v.data_ptr(), lam.data_ptr(), state_free.data_ptr(),
                lm_half.data_ptr(), self.u.data_ptr(), Hv.data_ptr(), pAp.data_ptr(), K, self.P,
                self.Lp, torch.cuda.current_stream(dev).cuda_stream))
        cuda_build.launch_counts[fn] += 1
        return Hv, pAp


# --- the LM iteration outside CG ---------------------------------------------

class Linearization(NamedTuple):
    """One linearization of the visual whole-map problem (``linearize``)."""

    Jp: torch.Tensor        # (M, D, 3, 6); on the card 0 where w == 0
    Jl: torch.Tensor        # (M, D, 3, 3); the same
    w: torch.Tensor         # (M, D) weights, 0 where a slot is not active
    g_p: torch.Tensor       # (K, 6): Σ Jpᵀ·w·r over each pose's slots (before pose_free)
    Hpp_diag: torch.Tensor  # (K, 36): Σ (w·Jp)ᵀ·Jp
    g_l: torch.Tensor       # (M, 3): Σ Jlᵀ·w·r over each landmark's slots, times lm_free
    Hll_diag: torch.Tensor  # (M, 3, 3): Σ w·Jlᵀ·Jl
    cost: torch.Tensor      # () the robust cost
    n_active: torch.Tensor  # () int64 the active observations


def apply_step_plain(dp, poses, dl, lms):
    """The LM step's candidate: each pose exp(dp)·T renormalized, each
    landmark X + dl."""
    return lie.se3_normalize(lie.se3_mul(lie.se3_exp(dp), poses)), lms + dl


def camera_params(cam, huber=None):
    """(model, 12 float32s) for ``gba_linearize``: fx, fy, cx, cy, bf, the
    distortion terms (k1, k2, p1, p2, k3 of a pinhole; k0..k3 of a KB8), the
    Huber thresholds ``huber`` (stereo, mono; zeros for None)."""
    if is_fisheye(cam):
        model, k = KB8, (cam.k0, cam.k1, cam.k2, cam.k3, 0.0)
    elif cam.has_distortion:
        model, k = PINHOLE_DISTORTED, (cam.k1, cam.k2, cam.p1, cam.p2, cam.k3)
    else:
        model, k = PINHOLE, (0.0,) * 5
    values = (cam.fx, cam.fy, cam.cx, cam.cy, cam.bf, *k, *(huber or (0.0, 0.0)))
    return model, (ctypes.c_float * len(values))(*values)


def _check_problem(fn_name: str, P):
    """A ``BAProblem`` as the slot kernels take it; returns (device, K, M, D)."""
    dev = _device(fn_name, P.poses)
    K, (M, D) = P.poses.shape[0], P.obs_kf.shape
    f32, b = torch.float32, torch.bool
    for name, t, dtype, shape in (
            ("poses", P.poses, f32, (K, 7)), ("landmarks", P.landmarks, f32, (M, 3)),
            ("lm_valid", P.lm_valid, b, (M,)), ("pose_valid", P.pose_valid, b, (K,)),
            ("obs_kf", P.obs_kf, torch.int64, (M, D)), ("obs_uv", P.obs_uv, f32, (M, D, 2)),
            ("obs_ur", P.obs_ur, f32, (M, D)), ("obs_inv_sigma2", P.obs_inv_sigma2, f32, (M, D)),
            ("obs_mask", P.obs_mask, b, (M, D))):
        _check(fn_name, name, t, dtype, shape, dev)
    return dev, K, M, D


def _slot_args(P):
    return (P.poses.data_ptr(), P.landmarks.data_ptr(), P.lm_valid.data_ptr(),
            P.pose_valid.data_ptr(), P.obs_kf.data_ptr(), P.obs_uv.data_ptr(),
            P.obs_ur.data_ptr(), P.obs_inv_sigma2.data_ptr(), P.obs_mask.data_ptr())


def _partials(dev, M: int, D: int):
    """(landmarks a block, blocks, cost partials, count partials) of the slot kernels."""
    lpb = landmarks_per_block(D)
    nb = max(1, -(-M // lpb))
    return (lpb, nb, torch.empty((nb,), dtype=torch.float32, device=dev),
            torch.empty((nb,), dtype=torch.int32, device=dev))


def linearize(problem, cam, segments, huber, lm_free) -> Linearization:
    """One linearization of a ``BAProblem`` on the card (its ``segments``
    the ``PoseSegments`` of its observation table, ``huber`` the Huber
    thresholds (stereo, mono) or None, ``lm_free`` (M, 1) bool): one launch
    each of ``gba_linearize`` and ``gba_pose_blocks``. Float32 fields, int64
    keyframe indices, contiguous."""
    fn = "gba_linearize"
    dev, K, M, D = _check_problem(fn, problem)
    _check(fn, "lm_free", lm_free, torch.bool, (M, 1), dev)
    L = segments.table.shape[1]
    _check(fn, "segments.table", segments.table, torch.int64, (K, L), dev)
    if segments.n_obs != M * D:
        raise ValueError(f"{fn}: segments of {segments.n_obs} slots for a ({M}, {D}) table")
    model, params = camera_params(cam, huber)
    lpb, nb, cost_part, count_part = _partials(dev, M, D)
    f32 = torch.float32
    Jp = torch.empty((M, D, 3, 6), dtype=f32, device=dev)
    Jl = torch.empty((M, D, 3, 3), dtype=f32, device=dev)
    w = torch.empty((M, D), dtype=f32, device=dev)
    wr = torch.empty((M, D, 3), dtype=f32, device=dev)
    g_l = torch.empty((M, 3), dtype=f32, device=dev)
    Hll = torch.empty((M, 3, 3), dtype=f32, device=dev)
    g_p = torch.empty((K, 6), dtype=f32, device=dev)
    Hpp = torch.empty((K, 36), dtype=f32, device=dev)
    total = torch.empty((), dtype=f32, device=dev)
    n_active = torch.empty((), dtype=torch.int64, device=dev)
    k = _kernels()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _raise_on(fn, k["linearize"](
            *_slot_args(problem), lm_free.data_ptr(), params, model, int(huber is not None), 1, M,
            D, lpb, nb, Jp.data_ptr(), Jl.data_ptr(), w.data_ptr(), wr.data_ptr(),
            g_l.data_ptr(), Hll.data_ptr(), None, None, cost_part.data_ptr(),
            count_part.data_ptr(), stream))
        cuda_build.launch_counts[fn] += 1
        _raise_on("gba_pose_blocks", k["pose_blocks"](
            Jp.data_ptr(), w.data_ptr(), wr.data_ptr(), segments.table.data_ptr(), K, L, M * D,
            cost_part.data_ptr(), count_part.data_ptr(), nb, g_p.data_ptr(), Hpp.data_ptr(),
            total.data_ptr(), n_active.data_ptr(), stream))
        cuda_build.launch_counts["gba_pose_blocks"] += 1
    return Linearization(Jp=Jp, Jl=Jl, w=w, g_p=g_p, Hpp_diag=Hpp, g_l=g_l, Hll_diag=Hll,
                         cost=total, n_active=n_active)


def cost(problem, cam, huber, per_slot: bool = False):
    """(cost, active count) of a ``BAProblem`` as it stands, on the card;
    with ``per_slot`` also each slot's chi² and active mask (M, D). The
    slot pass is ``gba_linearize``'s without Jacobians, its sum
    ``gba_pose_blocks``' last block: two launches, one ``gba_cost`` count, and
    the same bits as ``linearize``'s cost for the same poses and landmarks."""
    fn = "gba_cost"
    dev, K, M, D = _check_problem(fn, problem)
    model, params = camera_params(cam, huber)
    lpb, nb, cost_part, count_part = _partials(dev, M, D)
    total = torch.empty((), dtype=torch.float32, device=dev)
    n_active = torch.empty((), dtype=torch.int64, device=dev)
    chi2 = torch.empty((M, D), dtype=torch.float32, device=dev) if per_slot else None
    active = torch.empty((M, D), dtype=torch.bool, device=dev) if per_slot else None
    k = _kernels()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _raise_on(fn, k["linearize"](
            *_slot_args(problem), None, params, model, int(huber is not None), 0, M, D, lpb, nb,
            *(None,) * 6, chi2.data_ptr() if per_slot else None,
            active.data_ptr() if per_slot else None, cost_part.data_ptr(),
            count_part.data_ptr(), stream))
        _raise_on(fn, k["pose_blocks"](
            None, None, None, None, 0, 0, 0, cost_part.data_ptr(), count_part.data_ptr(), nb,
            None, None, total.data_ptr(), n_active.data_ptr(), stream))
    cuda_build.launch_counts[fn] += 1
    return (total, n_active, chi2, active) if per_slot else (total, n_active)


def apply_step(dp, poses, dl, lms):
    """``apply_step_plain``; on the card one launch of ``gba_apply_step``
    (dp (K, 6), poses (K, 7), dl and lms (M, 3): float32, contiguous)."""
    if poses.device.type == "cpu":
        return apply_step_plain(dp, poses, dl, lms)
    fn = "gba_apply_step"
    dev = _device(fn, poses)
    K, M = poses.shape[0], lms.shape[0]
    for name, t, shape in (("dp", dp, (K, 6)), ("poses", poses, (K, 7)), ("dl", dl, (M, 3)),
                           ("lms", lms, (M, 3))):
        _check(fn, name, t, torch.float32, shape, dev)
    new_poses = torch.empty((K, 7), dtype=torch.float32, device=dev)
    new_lms = torch.empty((M, 3), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _raise_on(fn, _kernels()["apply_step"](
            dp.data_ptr(), poses.data_ptr(), dl.data_ptr(), lms.data_ptr(), new_poses.data_ptr(),
            new_lms.data_ptr(), K, M, torch.cuda.current_stream(dev).cuda_stream))
    cuda_build.launch_counts[fn] += 1
    return new_poses, new_lms
