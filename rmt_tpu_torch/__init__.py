# PyTorch/CUDA port of rmt_tpu, the reactor modeling framework, for NVIDIA
# Hopper cards. The package mirrors rmt_tpu's module layout (the
# counterpart of rmt_tpu/models/homo.py is rmt_tpu_torch/models/homo.py)
# and imports neither jax nor rmt_tpu. Importing it builds nothing: the
# CUDA kernels under csrc/ are compiled by nvcc at their first launch
# (ops/_build.py).

from . import config as _config

_config.setup()

from .api.rmt import rmtExe, rmtCom  # noqa: E402

__version__ = "0.1.0"
__all__ = ["rmtExe", "rmtCom", "__version__"]
