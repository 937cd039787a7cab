"""CRAB (Chopped RAndom Basis) parameterized control functions.

Re-implements the reference's CRAB family
(``src/parameterized_functions/crab.jl``): controls of the form

``f(t) = c₀·g(t) + S(t)·Σᵢ [c⁺ᵢ cos(ωᵢ t) + c⁻ᵢ sin(ωᵢ t)]``

with randomized frequencies ``ωᵢ``, an optional guess pulse ``g`` with
tunable weight ``c₀``, an optional static shape ``S``, and a parity
restriction (``'even'`` → cos only, ``'odd'`` → sin only,
``'evenodd'`` → both).  :class:`VariedFrequencyCRABFunction` adds
per-frequency scale parameters ``rᵢ`` so the frequencies themselves are
tunable.

Parameter vector layout (``crab_initial_parameters``, reference
``crab.jl:166-183``): ``[c₀?] + freq_weights + [r₁..r_N?]`` — ``c₀``
present iff a guess is scaled; ``freq_weights`` has length ``N`` for
single-parity, ``2N`` for ``'evenodd'`` (cos block then sin block);
``rᵢ`` present only for the varied-frequency variant.

Evaluation is vectorized over the frequency axis (a dot product with
the cos/sin bank), so discretizing a CRAB control over thousands of
time points is a single broadcast rather than a scalar loop.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from .controls import ParameterizedFunction

__all__ = [
    "CRABFunction",
    "VariedFrequencyCRABFunction",
    "crab_initial_parameters",
]

_PARITIES = ("evenodd", "odd", "even")


def crab_initial_parameters(
    N: int,
    *,
    guess=None,
    scale_guess: bool = True,
    random_amplitude: bool = False,
    vary_frequencies: bool = False,
    parity: str = "evenodd",
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Random initial parameter vector for a CRAB function (reference
    ``crab.jl:166-183``): frequency weights uniform in [-1, 1] if
    ``random_amplitude``, else zero; guess weight 1; frequency scales 1.
    """
    if rng is None:
        rng = np.random.default_rng()
    if guess is None:
        scale_guess = False
    guess_weight = [1.0] if scale_guess else []
    n_weights = N if parity in ("odd", "even") else 2 * N
    freq_weights = np.zeros(n_weights)
    if random_amplitude:
        freq_weights = 1.0 - 2.0 * rng.random(n_weights)
    freq_scales = np.ones(N) if vary_frequencies else np.zeros(0)
    return np.concatenate([guess_weight, freq_weights, freq_scales])


class _CRABBase(ParameterizedFunction):
    _vary_frequencies = False

    def __init__(
        self,
        N: int,
        *,
        max_frequency: float = 0.0,
        rng: Optional[np.random.Generator] = None,
        frequencies=None,
        guess: Optional[Callable] = None,
        shape: Optional[Callable] = None,
        parity: str = "evenodd",
        scale_guess: bool = True,
        random_amplitude: bool = True,
        parameters=None,
    ):
        if rng is None:
            rng = np.random.default_rng()
        if parity == "oddeven":
            parity = "evenodd"
        if parity not in _PARITIES:
            raise ValueError(f"parity must be one of {_PARITIES}, not {parity!r}")
        if frequencies is None:
            frequencies = np.sort(max_frequency * rng.random(N))
        frequencies = np.asarray(frequencies, dtype=np.float64)
        if len(frequencies) != N:
            raise ValueError(
                f"Length of frequencies {len(frequencies)} must match N={N}"
            )
        if np.all(frequencies == 0):
            raise ValueError(
                f"The `frequencies` in {type(self).__name__} cannot be all "
                "zero. Did you forget to pass `max_frequency`?"
            )
        if isinstance(guess, (list, np.ndarray)):
            raise ValueError(
                f"{type(self).__name__} cannot be instantiated with a vector "
                "of pulse values as a guess"
            )
        if guess is None:
            scale_guess = False
        if parameters is None:
            parameters = crab_initial_parameters(
                N,
                guess=guess,
                scale_guess=scale_guess,
                random_amplitude=random_amplitude,
                vary_frequencies=self._vary_frequencies,
                parity=parity,
                rng=rng,
            )
        parameters = np.asarray(parameters, dtype=np.float64)
        expected = len(
            crab_initial_parameters(
                N,
                guess=guess,
                scale_guess=scale_guess,
                vary_frequencies=self._vary_frequencies,
                parity=parity,
            )
        )
        if len(parameters) != expected:
            raise ValueError(
                f"Number of parameters must be {expected}, not {len(parameters)}"
            )
        self.parameters = parameters
        self.frequencies = frequencies
        self.guess = guess
        self.shape = shape
        self.scale_guess = bool(scale_guess)
        self.parity = parity
        # offsets into the parameter vector (0-based slice starts)
        self.i_cos = 1 if scale_guess else 0
        self.i_sin = self.i_cos + (N if parity != "odd" else 0)
        self.N = N

    def _freq_scales(self) -> np.ndarray:
        if self._vary_frequencies:
            return self.parameters[-self.N:]
        return np.ones(self.N)

    def __call__(self, t: float) -> float:
        w = self.frequencies * self._freq_scales()
        f = 0.0
        if self.parity in ("even", "evenodd"):
            c_cos = self.parameters[self.i_cos : self.i_cos + self.N]
            f += float(np.dot(c_cos, np.cos(w * t)))
        if self.parity in ("odd", "evenodd"):
            c_sin = self.parameters[self.i_sin : self.i_sin + self.N]
            f += float(np.dot(c_sin, np.sin(w * t)))
        if self.shape is not None:
            f *= float(self.shape(t))
        if self.guess is not None:
            if self.scale_guess:
                f += float(self.parameters[0]) * float(self.guess(t))
            else:
                f += float(self.guess(t))
        return f


class CRABFunction(_CRABBase):
    """CRAB control with fixed random frequencies (reference
    ``crab.jl:79-257``)."""

    _vary_frequencies = False


class VariedFrequencyCRABFunction(_CRABBase):
    """CRAB control whose frequencies carry tunable scales ``rᵢ``
    (reference ``crab.jl:283-355``)."""

    _vary_frequencies = True
