"""The benchmark of ceres_slam_tpu_torch on one NVIDIA H100 (``python -m benchmark.run``)."""
