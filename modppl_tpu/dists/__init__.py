"""Distributions with analytic log-densities and counter-based samplers.

JAX counterpart of modppl/src/modeling/dists/ — same 10 singletons,
same parameterizations (SURVEY.md §2), pure-jnp logpdfs and jax.random
samplers — plus extensions beyond the reference (dists/extra.py):
exponential, laplace, student_t, binomial, dirichlet, negative_binomial.
"""

from modppl_tpu.dists.base import Distribution, u01
from modppl_tpu.dists.scalar import (
    bernoulli,
    uniform_continuous,
    uniform,
    uniform_discrete,
    categorical,
    normal,
    geometric,
    poisson,
    gamma,
    beta,
    Bernoulli,
    UniformContinuous,
    UniformDiscrete,
    Categorical,
    Normal,
    Geometric,
    Poisson,
    Gamma,
    Beta,
)
from modppl_tpu.dists.mvnormal import mvnormal, MvNormal
from modppl_tpu.dists.extra import (
    exponential,
    laplace,
    student_t,
    binomial,
    dirichlet,
    negative_binomial,
    Exponential,
    Laplace,
    StudentT,
    Binomial,
    Dirichlet,
    NegativeBinomial,
)

__all__ = [
    "Distribution", "u01",
    "bernoulli", "uniform_continuous", "uniform", "uniform_discrete",
    "categorical", "normal", "mvnormal", "geometric", "poisson", "gamma", "beta",
    "Bernoulli", "UniformContinuous", "UniformDiscrete", "Categorical",
    "Normal", "MvNormal", "Geometric", "Poisson", "Gamma", "Beta",
    "exponential", "laplace", "student_t", "binomial", "dirichlet",
    "negative_binomial",
    "Exponential", "Laplace", "StudentT", "Binomial", "Dirichlet",
    "NegativeBinomial",
]
