"""The benchmark of rmt_tpu_torch, the PyTorch and CUDA port: design sweeps
of the N2 dynamic reactor on the lockstep Radau integrator, one cell per
run (run.py). Imports neither jax nor rmt_tpu."""
