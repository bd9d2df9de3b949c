"""stereo_semantic_vo_tpu_torch: the PyTorch and CUDA port of stereo_semantic_vo_tpu.

The JAX package beside this one is the reference.  This package imports
``torch`` and never ``jax``; parity tests in ``tests/test_torch_*.py`` feed
both packages the same numpy inputs.

Layout (each module mirrors its counterpart in the JAX package):
  core/      configuration, SE(3)/SO(3), camera model, float32 precision
  kernels/   hand-written CUDA kernels for Hopper (sources in csrc/), each
             beside its plain PyTorch version, and the nvcc build
  ops/       ORB (upright and steered BRIEF), sparse and dense stereo,
             epipolar test, RANSAC PnP, motion-only and local BA,
             triangulation
  models/    the cfg-driven YOLO detector (cuDNN convolutions, decode, NMS),
             its model zoo, its trainer (live BN, region and yolo losses,
             darknet's SGD) and the training augmentation
  engine/    tracker state, init/track steps, window BA, sequence pipeline
             (online detection one frame late on a side CUDA stream,
             resume from a checkpoint), trajectories
  parallel/  data-parallel tracker, landmark-sharded window BA, replicated
             detector
  io/        KITTI loading (native C++ prefetcher or Pillow), the procedural
             two-plane sequence, darknet cfg and weights
  eval/      ATE / RPE
  utils/     checkpoints of the VO state, the tracer (stage stamps in the
             step graphs, program spans), profiler traces
  viz/       trajectory, map, match and box figures (matplotlib)
  tools/     on-card timing and profiling scripts, the replay-training tool
  interop.py config, state and trainer-state exchange with the JAX package
             (numpy only)
  run.py     the KITTI command line
"""

__version__ = "0.1.0"
