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
"""

from __future__ import annotations

import ctypes
import functools

import torch

from orb_slam3_rgbl_tpu_torch import cuda_build

THREADS = 256          # csrc/gba.cu THREADS: threads of a block, slots of an H·v tile
MAX_D = THREADS        # csrc/gba.cu MAX_D: most observation slots a landmark
PAIR_THREADS = 1024    # csrc/gba.cu PAIR_THREADS: threads of the one gba_pair_hv block
WIDTHS = (6, 15)       # pose blocks of the visual solve, states of the inertial one


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
    fns = {"hv": (lib.gba_hv_f32, [p] * 11 + [i] * 5 + [p]),
           "pose_sum": (lib.gba_pose_sum_f32, [p] * 3 + [i, i, ll, p, i, p, p, p]),
           "update": (lib.gba_cg_update_f32, [p] * 20 + [i, i, i, p]),
           "direction": (lib.gba_cg_direction_f32, [p] * 8 + [i, i, i, p]),
           "pair_hv": (lib.gba_pair_hv_f32, [p] * 13 + [i] * 3 + [p])}
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
