from .ensemble import (batch_params, make_n1_ensemble, make_n2_ensemble,
                       prepare_n2_ensemble, run_n2_ensemble,
                       run_n2_ensemble_lockstep, run_m10_sweep,
                       run_m11_sweep, run_m12_sweep, run_m13_sweep,
                       run_m14_sweep)
from .estimation import (make_estimation_step, outlet_mole_fractions,
                         simulate_n2_fixed, simulate_n2_implicit)
from .mesh import Mesh, make_mesh, shard_batch
