from .dsl import RateProgram, compile_rate_program
from .stoich import Stoichiometry, parse_reaction
