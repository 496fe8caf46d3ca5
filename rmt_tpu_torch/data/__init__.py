from . import defaults, species
from .defaults import (
    CATALYST,
    MEMBRANE,
    REACTOR,
    calConcentration,
    calTotalConcentration,
    setFeedMoleFraction,
)
from .species import SPECIES, species_index, species_indices, component_symbols
