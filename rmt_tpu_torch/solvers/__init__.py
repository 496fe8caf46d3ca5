from . import radau, stiff_ensemble
