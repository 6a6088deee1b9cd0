"""The users' offline tools and probes (counterparts of the repository's
root ``tools/`` and ``evaluation/evaluate_ate.py``, which run the JAX
package). Each is ``python -m orb_slam3_rgbl_tpu_torch.tools.<name>`` with
``main(argv=None)``, and runs on the card unless given ``--device cpu``."""
