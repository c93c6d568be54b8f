"""BASQ: batch Bayesian quadrature for evidence and posterior inference
(port of sober_tpu/apps/basq.py; SOBER/BASQ/_basq.py).

The evidence E[Z] = w^T mu_g(x) comes from kernel recombination on the
g-space kernel of a ScaleMmltGP, with the integrand pinned as an extra test
function; the posterior pdf, SIR posterior sampling through the learned
proposal mixed with the prior, and a sample-max MAP follow from it.
"""
from __future__ import annotations

import torch

from ..core.rchq import recombination
from ..core.sampler import MixtureSampler
from ..utils.prng import KeyRing
from ..utils.weights import cleansing_weights, weighted_resampling


class BASQ:
    def __init__(self, prior, model, sober, ratio_wkde: float = 1.0,
                 seed: int = 0, verbose: bool = True):
        """(SOBER/BASQ/_basq.py:6-26)

        Args:
          prior: the prior distribution (its device is BASQ's)
          model: a ScaleMmltGP BQ model
          sober: a Sober whose learned proposal the posterior sampler mixes in
          ratio_wkde: the share of mixture samples drawn from that proposal
          seed: seeds BASQ's KeyRing
        """
        self.prior = prior
        self.keys = KeyRing(seed, device=prior.device)
        self.verbose = verbose
        self.update_model(model, sober, ratio_wkde=ratio_wkde)

    def update_model(self, model, sober, ratio_wkde: float = 1.0):
        """(SOBER/BASQ/_basq.py:28-40)"""
        self.kernel = model.gspace_kernel
        self.pred_mean = model.gspace_mean_predict
        self.beta = model.beta
        self.sampler = MixtureSampler(self.prior, sober, ratio_wkde=ratio_wkde)

    def quadrature(self, n_quad: int, n_nys_quad: int, n_res_quad: int):
        """Evidence estimate (SOBER/BASQ/_basq.py:42-81): n_quad prior
        draws sparsified to n_res_quad nodes, the first n_nys_quad draws the
        Nystrom points and the g-space mean pinned as a test function, so
        the estimate stays exact even where the kernel is numerically
        degenerate. Returns (ELML, AVLML): the expected log marginal
        likelihood and the log of its variance."""
        x_cand = self.prior.sample(self.keys.next(), n_quad)
        w_is = torch.full((n_quad,), 1.0 / n_quad, device=x_cand.device)
        mean_row = self.pred_mean(x_cand)[None, :]
        idx, w = recombination(x_cand, x_cand[:n_nys_quad], n_res_quad,
                               self.kernel, init_weights=w_is,
                               extra_test_rows=mean_row)
        x = x_cand[idx]
        eml = w @ self.pred_mean(x)
        # the evidence stays in log space: exp(beta) overflows float32 for
        # beta > ~88 and would zero every posterior call
        if float(eml) <= 0:
            elml = self.beta
            self.log_EML = torch.as_tensor(self.beta, dtype=torch.float32)
        else:
            self.log_EML = torch.log(eml)
            elml = self.log_EML + self.beta
        avlml = torch.log(torch.abs(w @ self.kernel(x, x) @ w))
        if self.verbose:
            print(f"Expected log marginal likelihood: {float(elml):.5e}")
            print(f"Variance log marginal likelihood: {float(avlml):.5e}")
        return float(elml), float(avlml)

    def _require_evidence(self):
        if not hasattr(self, "log_EML"):
            raise ValueError("Evidence has not yet computed.")

    @property
    def EML(self):
        """g-space evidence (reference attribute, SOBER/BASQ/_basq.py:71)."""
        self._require_evidence()
        return torch.exp(self.log_EML)

    def log_posterior(self, x) -> torch.Tensor:
        """log of the estimated posterior pdf, up to float32-safe clamping."""
        self._require_evidence()
        lik_pred = torch.clamp_min(self.pred_mean(x), 0.0)
        return (torch.log(lik_pred + 1e-38)
                + torch.log(self.prior.pdf(x) + 1e-38) - self.log_EML)

    def posterior(self, x) -> torch.Tensor:
        """Estimated posterior pdf (SOBER/BASQ/_basq.py:83-102)."""
        self._require_evidence()
        lik_pred = torch.clamp_min(self.pred_mean(x), 0.0)
        return lik_pred * self.prior.pdf(x) * torch.exp(-self.log_EML)

    def sampling_posterior(self, n_samples: int, ratio_super: int = 100
                           ) -> torch.Tensor:
        """SIR posterior sampling (SOBER/BASQ/_basq.py:104-123). Importance
        weights are formed in log space and max-shifted before the exp, so
        an extreme log_EML cannot underflow them all."""
        samples = self.sampler.sample(self.keys.next(),
                                      int(ratio_super * n_samples))
        log_w = self.log_posterior(samples) - torch.log(
            torch.clamp_min(self.sampler.pdf(samples), 1e-38))
        w = cleansing_weights(torch.exp(log_w - torch.max(log_w)))
        return samples[weighted_resampling(self.keys.next(), w, n_samples)]

    def MAP(self, n_samples: int) -> torch.Tensor:
        """Sample-max maximum a posteriori (SOBER/BASQ/_basq.py:125-138)."""
        samples = self.sampler.sample(self.keys.next(), n_samples)
        return samples[torch.argmax(self.log_posterior(samples))]
