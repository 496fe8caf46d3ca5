from .ensemble import batch_params, prepare_n2_ensemble, run_n2_ensemble_lockstep
