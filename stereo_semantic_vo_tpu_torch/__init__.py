"""stereo_semantic_vo_tpu_torch: the PyTorch and CUDA port of stereo_semantic_vo_tpu.

The JAX package beside this one is the reference.  This package imports
``torch`` and never ``jax``; parity tests in ``tests/test_torch_*.py`` feed
both packages the same numpy inputs.

Layout (each module mirrors its counterpart in the JAX package):
  core/      configuration, SE(3)/SO(3), camera model, float32 precision
  kernels/   hand-written CUDA kernels for Hopper (sources in csrc/), each
             beside its plain PyTorch version, and the nvcc build
  ops/       ORB (upright BRIEF), sparse stereo, epipolar test, RANSAC PnP,
             motion-only BA
  models/    the cfg-driven YOLO detector (cuDNN convolutions, decode, NMS)
             and its model zoo
  engine/    tracker state, init/track steps, sequence pipeline (online
             detection one frame late on a side CUDA stream), trajectories
  io/        KITTI loading, the procedural two-plane sequence, darknet cfg
             and weights
  eval/      ATE / RPE
  interop.py config and state exchange with the JAX package (numpy only)
  run.py     the KITTI command line
"""

__version__ = "0.1.0"
