# Reaction-equation parsing -> dense stoichiometry matrices.
#
# The reference parses "CO2 + 3H2 <=> CH3OH + H2O" with a regex and then
# matches species symbols in a python triple loop on every RHS call
# (reference: PyREMOT/docs/rmtUtility.py:172-249,
#  PyREMOT/docs/rmtReaction.py:64-97). Here parsing happens once at model
# build time, producing
#   * nu_comp  (n_rxn, n_comp): coefficients aligned to the feed component
#     list -- formation rates become the matmul  ri = R @ nu_comp
#   * eq_idx / eq_nu: database rows + coefficients for *all* species that
#     appear in the equations (used for reaction enthalpies, which in the
#     reference include species even when absent from the feed list).

from __future__ import annotations

import re
from typing import Mapping, Sequence

import numpy as np

from ..data import species as DB

_TERM_RE = re.compile(r"([0-9.]*)([a-zA-Z0-9.]+)")


def parse_reaction(expr: str) -> list[tuple[str, float]]:
    """Parse one reaction string into (symbol, signed coeff) terms.

    Reactants get negative coefficients, products positive
    (reference: rmtUtility.py:187-214).
    """
    body = expr.replace("<", "").replace(">", "")
    sides = body.replace(" ", "").split("=")
    terms: list[tuple[str, float]] = []
    for sign, side in ((-1.0, sides[0]), (1.0, sides[1])):
        for coeff_s, symbol in _TERM_RE.findall(side):
            coeff = float(coeff_s) if coeff_s else 1.0
            terms.append((symbol, sign * coeff))
    return terms


class Stoichiometry:
    """Static stoichiometric data for a reaction set."""

    def __init__(self, reaction_dict: Mapping[str, str], comp_list: Sequence[str]):
        self.reaction_list = list(reaction_dict.values())
        self.comp_list = list(comp_list)
        self.n_rxn = len(self.reaction_list)
        self.n_comp = len(self.comp_list)

        parsed = [parse_reaction(r) for r in self.reaction_list]

        # coefficients aligned to the feed component list (species that only
        # appear in the equations do not contribute to formation rates --
        # same behavior as the reference's symbol-matching loop)
        comp_pos = {s: i for i, s in enumerate(self.comp_list)}
        nu_comp = np.zeros((self.n_rxn, self.n_comp))
        for m, terms in enumerate(parsed):
            for symbol, coeff in terms:
                j = comp_pos.get(symbol)
                if j is not None:
                    nu_comp[m, j] += coeff
        self.nu_comp = nu_comp

        # all species appearing in the equations, mapped to database rows.
        # Species absent from the database are dropped here, i.e. contribute
        # zero formation enthalpy/Cp -- the reference behaves the same way
        # for dHf25 (empty lookup list, rmtThermo.py:164-178)
        eq_symbols: list[str] = []
        for terms in parsed:
            for symbol, _ in terms:
                if symbol not in eq_symbols and symbol in DB.SPECIES:
                    eq_symbols.append(symbol)
        self.eq_symbols = tuple(eq_symbols)
        self.eq_idx = DB.species_indices(eq_symbols)
        eq_pos = {s: i for i, s in enumerate(eq_symbols)}
        eq_nu = np.zeros((self.n_rxn, len(eq_symbols)))
        for m, terms in enumerate(parsed):
            for symbol, coeff in terms:
                if symbol in eq_pos:
                    eq_nu[m, eq_pos[symbol]] += coeff
        self.eq_nu = eq_nu

        # standard heat of reaction at 25C [kJ/kmol]
        # (reference: rmtThermo.py:129-198 -- kJ/mol * 1000)
        self.dh_rxn_25 = (self.eq_nu @ DB.DHF25[self.eq_idx]) * 1000.0

    def formation_rates(self, rxn_rates):
        """Per-component formation rates: ri = R @ nu_comp. Shape (..., n_comp)."""
        return rxn_rates @ self.nu_comp
