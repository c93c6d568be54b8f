"""Gram kernels and the hand-written CUDA kernels of the port."""
from .car import car_eliminate, car_eliminate_reference
from .kernels import (KERNELS, Kernel, linear_gram, make_kernel,
                      matern12_gram, matern32_gram, matern52_gram, sqdist)
from .rbf_gram import rbf_gram, rbf_gram_reference

__all__ = ["KERNELS", "Kernel", "make_kernel", "sqdist", "rbf_gram",
           "rbf_gram_reference", "matern12_gram", "matern32_gram",
           "matern52_gram", "linear_gram", "car_eliminate",
           "car_eliminate_reference"]
