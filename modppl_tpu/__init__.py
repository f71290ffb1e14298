"""modppl_tpu — a compiled probabilistic-programming inference engine in JAX.

A from-scratch JAX/XLA/Pallas re-design with the capabilities of the
reference `modppl` Rust library (agarret7/modppl): the Generative Function
Interface (simulate/generate/update/regenerate over choice maps), a
handler-based modeling DSL, and a standard inference library (importance
sampling/resampling, proposal-based and regenerative Metropolis-Hastings,
Unfold-kernel particle filtering) — extended with compiled vectorized
inference (vmap/scan/shard_map), HMC/NUTS, and VI.

Modeling and inference are separated by the GenFn interface: any object
implementing it composes with every inference procedure (the reference's
crucial architectural property, modppl/src/lib.rs:2-5).
"""

from modppl_tpu.core import (
    ArgDiff,
    GenFn,
    Selection,
    Trace,
    Trie,
    normalize_addr,
    select,
    split_addr,
)
from modppl_tpu.dists import (
    Distribution,
    bernoulli,
    beta,
    categorical,
    gamma,
    geometric,
    mvnormal,
    normal,
    poisson,
    u01,
    uniform,
    uniform_continuous,
    uniform_discrete,
)
from modppl_tpu.modeling import Gen, gen
from modppl_tpu.utils import logsumexp

__version__ = "0.1.0"

__all__ = [
    # core
    "ArgDiff", "GenFn", "Selection", "Trace", "Trie",
    "normalize_addr", "select", "split_addr",
    # dists
    "Distribution", "u01", "bernoulli", "uniform_continuous", "uniform",
    "uniform_discrete", "categorical", "normal", "mvnormal", "geometric",
    "poisson", "gamma", "beta",
    # modeling
    "Gen", "gen",
    # utils
    "logsumexp",
]
