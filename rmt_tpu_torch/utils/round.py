# Rounding helper with the reference's default accuracy
# (reference: PyREMOT/core/utilities.py:9-14, core/config.py:8-24).
import numpy as np

ROUND_FUN_ACCURACY = 3
MOLE_FRACTION_ACCURACY = 4
CONCENTRATION_ACCURACY = 7
REACTION_RATE_ACCURACY = 5


def roundNum(value, accuracy: int = ROUND_FUN_ACCURACY):
    return np.round(value, accuracy)
