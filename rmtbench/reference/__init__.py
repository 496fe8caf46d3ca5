"""The float64 reference of the benchmark's configurations: plain NumPy,
integrated by SciPy. Imports nothing of rmt_tpu_torch, rmt_tpu or jax."""
