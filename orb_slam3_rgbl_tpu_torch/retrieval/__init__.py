"""Place recognition: binary-descriptor retrieval (counterpart of
``orb_slam3_rgbl_tpu.retrieval``). Each frame's descriptors become a dense
L1-normalized word histogram through multi-band bit-sampling LSH; every
stored keyframe is scored at once against a table that stays on the device.
"""
