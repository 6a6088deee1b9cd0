"""Multi-device scaling (counterpart of ``orb_slam3_rgbl_tpu.parallel``):
the whole-map bundle adjustment with its landmarks sharded over the ranks of
a ``torch.distributed`` group (NCCL between cards, gloo on the CPU or for
ranks that share a card); the poses are replicated and the pose-space sums
all-reduced."""
