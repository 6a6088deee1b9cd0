"""PyTorch/CUDA port of the RGB-L SLAM engine.

The JAX package ``orb_slam3_rgbl_tpu`` is the reference; module names here
mirror it so each port file has an obvious counterpart. This package
imports ``torch`` and never ``jax`` or the JAX package.

Entry points (``FastPath``, ``make_track_step``, ``extract_features``,
``synthetic.*``) run on ``cuda`` unless the caller passes
``device="cpu"``; without a card they raise instead of falling back.
The two hand-written Hopper kernels on the tracking path live in
``csrc/`` and are built with ``nvcc`` on first use (``cuda_build``).
"""

__version__ = "0.1.0"
