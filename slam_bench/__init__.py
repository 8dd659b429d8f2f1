"""The benchmark of gf_orb_slam_tpu_torch: one SLAM session replaying a
fixed segment in rounds on one card (run.py)."""
