"""Gram kernels and the hand-written CUDA kernels of the port; the names of
sober_tpu.ops.__all__, and the CAR and RBF wrappers beside their plain
versions.

As in the JAX package, `ops.kmeans` and `ops.tanimoto_gram` are the
functions, not the submodules: import the submodules by their full path
(`sober_tpu_torch.ops.tanimoto_gram`). `rbf_gram_pallas` and
`tanimoto_gram_pallas`, the JAX package's Pallas kernels, name the CUDA
wrappers that replace them."""
from .car import car_eliminate, car_eliminate_reference
from .kernels import (KERNELS, Kernel, linear_gram, make_kernel,
                      matern12_gram, matern32_gram, matern52_gram, sqdist,
                      tanimoto_gram)
from .kmeans import kmeans, kmeans_resampling
from .rbf_gram import rbf_gram, rbf_gram_reference
from .tanimoto_gram import tanimoto_similarity

rbf_gram_pallas = rbf_gram
tanimoto_gram_pallas = tanimoto_similarity

__all__ = ["KERNELS", "Kernel", "make_kernel", "sqdist", "rbf_gram",
           "matern12_gram", "matern32_gram", "matern52_gram", "linear_gram",
           "tanimoto_gram", "kmeans", "kmeans_resampling",
           "tanimoto_gram_pallas", "rbf_gram_pallas",
           "rbf_gram_reference", "car_eliminate", "car_eliminate_reference"]
