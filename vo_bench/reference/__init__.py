"""The benchmark's plain reference of the stereo tracker.

A frozen copy, in plain PyTorch, of the tracking step that
``stereo_semantic_vo_tpu_torch`` runs: ORB with upright or steered BRIEF,
sparse (per-keypoint strips) or dense (cost volumes and SGM) stereo,
Hamming matching, epipolar culling, RANSAC-PnP with the threefry draws of
``jax.random``, motion-only and window BA, and the ring-map update.  Every
hand-written kernel of the port is replaced here by the plain arithmetic of
its contract.  It imports neither JAX, nor the JAX package, nor anything of
the port, so the benchmark can hold the port's outputs against it.

``tracker.init_step`` / ``tracker.track_step`` / ``window_ba.refine_state``
are the entry points; ``config.VOConfig.from_dict`` builds the configuration
from a benchmark configuration file; ``precision.matmul_precision(tf32=True)``
runs them with every float32 product in TF32 (the control of the check).
"""
