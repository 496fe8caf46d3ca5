from . import dopri5, fixed, radau, stiff_ensemble
