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
"""

from __future__ import annotations

import ctypes
import functools

import torch

from orb_slam3_rgbl_tpu_torch import cuda_build

THREADS = 256          # csrc/gba.cu THREADS: threads of a block, slots of an H·v tile
MAX_D = THREADS        # csrc/gba.cu MAX_D: most observation slots a landmark


def hv_plain(Jp, Jl, w, obs_kf, segments, v_p, v_l, lam_l, lm_free):
    """This rank's pose sums of Jpᵀ·w·J·v (K, 6), the landmark half of H·v,
    (Jlᵀ·w·J·v + lam_l·v_l)·lm_free (M, 3), and its share v_l·Hv_l of the
    dot product v·H·v. ``segments``: the ``PoseSegments`` of ``obs_kf``."""
    Jv = (torch.einsum("mdij,mdj->mdi", Jp, v_p[obs_kf])
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
    fns = {"hv": (lib.gba_hv_f32, [p] * 11 + [i] * 4 + [p]),
           "pose_sum": (lib.gba_pose_sum_f32, [p] * 3 + [i, i, ll, p, i, p, p, p]),
           "update": (lib.gba_cg_update_f32, [p] * 20 + [i, i, p]),
           "direction": (lib.gba_cg_direction_f32, [p] * 8 + [i, i, p])}
    for fn, argtypes in fns.values():
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return {k: fn for k, (fn, _) in fns.items()}


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


def _check_pairs(fn_name: str, dev, K: int, M: int, **pairs):
    """Each (pose, landmark) pair: contiguous float32 (K, 6) and (M, 3) on ``dev``."""
    for name, (a, b) in pairs.items():
        _check(fn_name, name + "[0]", a, torch.float32, (K, 6), dev)
        _check(fn_name, name + "[1]", b, torch.float32, (M, 3), dev)


def _check_scalars(fn_name: str, dev, **scalars):
    """Each a float32 value on ``dev``: shape () or, from an ``all_reduce``'d
    buffer, (1,)."""
    for name, t in scalars.items():
        _check(fn_name, name, t, torch.float32, tuple(t.shape) if t.numel() == 1 else (), dev)


def _pair(dev, K: int, M: int):
    return (torch.empty((K, 6), dtype=torch.float32, device=dev),
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
        _check_pairs(fn, dev, K, M, v=(v_p, v_l))
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
                             self.dot_part.data_ptr(), M, D, self.lpb, self.nb, stream))
            cuda_build.launch_counts["gba_hv"] += 1
            _raise_on("gba_pose_sum", pose_sum(
                self.part.data_ptr(), w.data_ptr(), segments.table.data_ptr(), K, self.L, M * D,
                self.dot_part.data_ptr(), self.nb, Hp.data_ptr(), lm_half.data_ptr(), stream))
            cuda_build.launch_counts["gba_pose_sum"] += 1
        return Hp, Hv_l, lm_half


class BlockJacobi:
    """v ↦ ``precond_plain``'s pair for the inverted diagonal blocks
    ``Minv_p`` (K, 6, 6) and ``Minv_l`` (M, 3, 3), masks ``pose_free``
    (K, 1) and ``lm_free`` (M, 1) bool. On the card: float32, contiguous."""

    def __init__(self, Minv_p, Minv_l, pose_free, lm_free):
        self.args = (Minv_p, Minv_l, pose_free, lm_free)
        if Minv_p.device.type == "cpu":
            return
        fn = "gba_cg_update"
        dev = _device(fn, Minv_p)
        K, M = Minv_p.shape[0], Minv_l.shape[0]
        for name, t, dtype, shape in (
                ("Minv_p", Minv_p, torch.float32, (K, 6, 6)),
                ("Minv_l", Minv_l, torch.float32, (M, 3, 3)),
                ("pose_free", pose_free, torch.bool, (K, 1)),
                ("lm_free", lm_free, torch.bool, (M, 1))):
            _check(fn, name, t, dtype, shape, dev)
        self.dev, self.K, self.M = dev, K, M
        self.ptrs = (Minv_p.data_ptr(), Minv_l.data_ptr(), pose_free.data_ptr(),
                     lm_free.data_ptr())

    def __call__(self, v_p: torch.Tensor, v_l: torch.Tensor):
        Minv_p, Minv_l, pose_free, lm_free = self.args
        if Minv_p.device.type == "cpu":
            return precond_plain(Minv_p, Minv_l, v_p, v_l, pose_free, lm_free)
        fn, dev, K, M = "gba_cg_update", self.dev, self.K, self.M
        _check_pairs(fn, dev, K, M, v=(v_p, v_l))
        z_p, z_l = _pair(dev, K, M)
        # the apply alone: the step's scalars and vectors null, v in the residual's place
        with torch.cuda.device(dev):
            _raise_on(fn, _kernels()["update"](
                *self.ptrs, None, None, None, None, v_p.data_ptr(), v_l.data_ptr(),
                *[None] * 8, z_p.data_ptr(), z_l.data_ptr(), K, M,
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
        fn, dev, K, M = "gba_cg_update", self.dev, self.K, self.M
        _check_scalars(fn, dev, rz=rz, pAp=pAp)
        _check_pairs(fn, dev, K, M, x=x, rr=rr, p=p, Ap=Ap)
        xo, ro, z = _pair(dev, K, M), _pair(dev, K, M), _pair(dev, K, M)
        with torch.cuda.device(dev):
            _raise_on(fn, _kernels()["update"](
                *self.ptrs, rz.data_ptr(), pAp.data_ptr(),
                *(t.data_ptr() for pair in (x, rr, p, Ap, xo, ro, z) for t in pair), K, M,
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
    _check_scalars(fn, dev, rz_new=rz_new, rz=rz)
    _check_pairs(fn, dev, K, M, z=z, p=p)
    po = _pair(dev, K, M)
    with torch.cuda.device(dev):
        _raise_on(fn, _kernels()["direction"](
            rz_new.data_ptr(), rz.data_ptr(), *(t.data_ptr() for pair in (z, p, po) for t in pair),
            K, M, torch.cuda.current_stream(dev).cuda_stream))
    cuda_build.launch_counts["gba_cg_direction"] += 1
    return po
