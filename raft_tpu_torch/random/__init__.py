"""raft_tpu_torch.random — the RNG state, device distributions and the
dataset and graph generators of the port. (ref: cpp/include/raft/random.)"""

from raft_tpu_torch.random.rng_state import GeneratorType, RngState
from raft_tpu_torch.random.rng import (bernoulli, cauchy, discrete,
                                       exponential, fill, gumbel, laplace,
                                       logistic, lognormal, normal,
                                       normal_int, normal_table,
                                       pcg32_uint32, pcg32_uniform, permute,
                                       rayleigh, sample_without_replacement,
                                       scaled_bernoulli, uniform, uniform_int)
from raft_tpu_torch.random.make_blobs import make_blobs
from raft_tpu_torch.random.make_regression import make_regression
from raft_tpu_torch.random.multi_variable_gaussian import (
    DecompositionMethod, multi_variable_gaussian)
from raft_tpu_torch.random.rmat import rmat_from_uniforms, rmat_rectangular_gen

__all__ = ["GeneratorType", "RngState", "uniform", "uniform_int", "normal",
           "normal_int", "normal_table", "fill", "lognormal", "gumbel",
           "logistic", "exponential", "rayleigh", "laplace", "cauchy",
           "bernoulli", "scaled_bernoulli", "discrete", "permute",
           "sample_without_replacement", "pcg32_uint32", "pcg32_uniform",
           "make_blobs", "make_regression", "multi_variable_gaussian",
           "DecompositionMethod", "rmat_from_uniforms",
           "rmat_rectangular_gen"]
