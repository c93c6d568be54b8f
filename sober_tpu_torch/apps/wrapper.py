"""SoberWrapper, the guided end-to-end interface (port of
sober_tpu/apps/wrapper.py; SOBER/_sober_wrapper.py).

Prior construction, input transforms with unit-cube normalization and an
eigenbasis diagonalization, the black-box model's evaluation, the
run_SOBER / run_BASQ / run_SOBER_adaptively loops, results and checkpoints.
The surrogate, the acquisition and the quadrature run on the wrapper's
device (CUDA unless given); the black-box model is host code called on
numpy rows, all at once or one row a worker of a process pool.

The pool is the JAX package's `multiprocessing.Pool()`, in the platform's
default start method (fork on Linux). Its workers run only the model on
numpy rows, never torch or CUDA, so the CUDA context the parent holds is
not touched in them.
"""
from __future__ import annotations

import math
import time
from multiprocessing import Pool
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..config import resolve_device
from ..core.sober import Sober
from ..gp.exact import GPConfig, fit_gp
from ..gp.warped import ScaleMmltGP
from ..priors.continuous import Gaussian, TruncatedGaussian, Uniform
from ..utils.prng import KeyRing
from .basq import BASQ
from .bolfi import SOBERUCB, make_bolfi_model


def _eval_one(args):
    model, x_np, kwargs = args
    return np.asarray(model(x_np, **kwargs))


def _identity(x):
    return x


def diagonalization_of(covariance) -> torch.Tensor:
    """The eigenvectors of `covariance` (ascending eigenvalues), from a
    float64 eigh on the CPU: LAPACK's, which the JAX package reaches on the
    CPU too, so both packages normalize into the same basis (a repeated
    eigenvalue leaves the basis to the solver, and an eigenvector's sign
    flips its axis)."""
    cov = torch.as_tensor(covariance).detach().to("cpu", torch.float64)
    return torch.linalg.eigh(cov)[1].to(torch.float32)


class SoberWrapper:
    def __init__(
        self,
        model: Optional[Callable] = None,
        data=None,
        model_initial_samples: int = 0,
        mean=None,
        covariance=None,
        bounds=None,
        prior: str = "Uniform",
        maximize: bool = False,
        use_bolfi: bool = False,
        weights=None,
        custom_objective_and_loglikelihood: Optional[Callable] = None,
        transforms: Optional[Sequence] = None,
        seed: Optional[int] = None,
        disable_numpy_mode: bool = False,
        parallelization: bool = True,
        visualizations: bool = False,
        true_optimum=None,
        standalone: bool = True,
        device=None,
        **kwargs,
    ):
        """The guided SOBER interface (SOBER/_sober_wrapper.py:27-313).

        `model` maps parameter rows to observations fitted against `data`,
        or `custom_objective_and_loglikelihood` maps them to (objective,
        log-likelihood). `transforms` is a per-dimension list of (forward,
        inverse) numpy callables applied before the normalization onto the
        unit cube. Extra keyword arguments go to `model`. `device`: where the
        surrogate, the priors and the acquisition live (CUDA unless given).
        """
        self.device = resolve_device(device)
        f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=self.device)
        self.model = model
        self.model_kwargs = kwargs
        self.data = None if data is None else f32(data)
        self.keys = KeyRing(seed or 0, device=self.device)

        if bounds is not None:
            self.input_dim = len(bounds[0])
        elif mean is not None:
            self.input_dim = len(mean)
        else:
            raise ValueError("Either 'mean' and 'covariance' or 'bounds' needs to be set.")

        ident = (_identity, _identity)
        self.transforms = list(transforms or [ident] * self.input_dim)
        for i, tr in enumerate(self.transforms):
            if not tr or not tr[0] or not tr[1]:
                self.transforms[i] = ident

        if mean is not None:
            self.mean = f32(mean)
            transformed_mean = self.apply_transform(torch.atleast_2d(self.mean))

        if bounds is not None:
            b = f32(bounds)
            lo = self.apply_transform(torch.atleast_2d(b[0]))[0]
            hi = self.apply_transform(torch.atleast_2d(b[1]))[0]
            self.bounds = torch.stack([lo, hi])
            if mean is None:
                self.mean = self.reverse_transform(torch.atleast_2d((lo + hi) / 2.0))[0]
        elif mean is not None and covariance is not None:
            sd = torch.sqrt(torch.diag(f32(covariance)))
            self.bounds = torch.stack([transformed_mean[0] - 4 * sd,
                                       transformed_mean[0] + 4 * sd])
        else:
            raise ValueError("Either 'mean' and 'covariance' or 'bounds' needs to be set.")

        # the Gaussian priors are centred on the transformed mean, also when
        # only bounds were given
        transformed_mean = self.apply_transform(torch.atleast_2d(self.mean))

        if "Gaussian" in prior and covariance is None:
            # the chi2-derived default (SOBER/_sober_wrapper.py:203-212)
            from scipy.stats import chi2

            covariance = torch.diag((self.bounds[1] - self.bounds[0])
                                    / (2.0 * chi2(self.input_dim).ppf(0.95) ** 0.5))

        unit = torch.stack([torch.zeros(self.input_dim, device=self.device),
                            torch.ones(self.input_dim, device=self.device)])
        prior_cov = (0.5 / 4.0) ** 2 * torch.eye(self.input_dim, device=self.device)
        if prior == "Uniform":
            self.diagonalization = torch.eye(self.input_dim, device=self.device)
            self.prior = Uniform(unit, seed=seed or 0, device=self.device)
        elif prior == "Gaussian":
            self.diagonalization = diagonalization_of(covariance).to(self.device)
            self.prior = Gaussian(self.normalize_input(transformed_mean)[0], prior_cov,
                                  device=self.device)
        elif prior == "TruncatedGaussian":
            self.diagonalization = diagonalization_of(covariance).to(self.device)
            self.prior = TruncatedGaussian(self.normalize_input(transformed_mean)[0],
                                           prior_cov, unit, device=self.device)
        else:
            raise ValueError(
                "'prior' must be one of 'Uniform', 'Gaussian', or 'TruncatedGaussian'.")
        self.back_diagonalization = self.diagonalization.T

        # the eigenvalue order <-> parameter order map, for the plots'
        # back-transforms (SOBER/_sober_wrapper.py:250-264)
        self.diag_order = []
        for i in range(self.input_dim):
            base = self.normalize_input(self.apply_transform(torch.atleast_2d(self.mean)))
            test_vec = self.apply_transform(torch.atleast_2d(self.mean)).clone()
            test_vec[0, i] = self.bounds[0][i]
            moved = self.normalize_input(test_vec)
            self.diag_order.append(int(torch.argmax(torch.abs(base - moved)[0])))
        self.current_MAP = self.mean

        self.maximize = maximize
        self.use_bolfi = use_bolfi
        self.weights = (1.0 if weights is None and data is not None
                        else None if weights is None else f32(weights))
        self.custom_objective_and_loglikelihood = custom_objective_and_loglikelihood
        self.disable_numpy_mode = disable_numpy_mode
        self.parallelization = parallelization
        self.visualizations = visualizations

        self.true_optimum = true_optimum
        if true_optimum is not None:
            self.normalized_true_optimum = self.normalize_input(
                self.apply_transform(torch.atleast_2d(f32(true_optimum))))[0]
        else:
            self.normalized_true_optimum = None

        self.X_all = self.prior.sample(self.keys.next(), model_initial_samples)
        self.sober_iterations = 0
        self.surrogate_effective_samples = 0
        self.standalone = standalone
        if self.standalone:
            self.initialize_sober()

    # -- transforms ----------------------------------------------------------

    def normalize_input(self, x):
        """Transformed parameters -> the unit cube (SOBER/_sober_wrapper.py:364-378)."""
        scaled = (x - self.bounds[0]) / (self.bounds[1] - self.bounds[0])
        return scaled @ self.diagonalization.T

    def denormalize_input(self, x):
        """The unit cube -> transformed parameters (SOBER/_sober_wrapper.py:380-391)."""
        return self.bounds[0] + (self.bounds[1] - self.bounds[0]) * (
            x @ self.back_diagonalization.T)

    def apply_transform_and_normalize_one_variable(self, var, index):
        """One variable: parameter space -> the unit cube
        (SOBER/_sober_wrapper.py:427-442), the other coordinates at the
        current MAP, through the eigen-order map."""
        x = torch.as_tensor(self.current_MAP, dtype=torch.float32,
                            device=self.device).clone()
        x[index] = var
        z = self.normalize_input(self.apply_transform(torch.atleast_2d(x)))
        return float(z[0][self.diag_order[index]])

    def denormalize_and_reverse_transform_one_variable(self, var, index):
        """One variable: the unit cube -> parameter space
        (SOBER/_sober_wrapper.py:444-460)."""
        x = torch.as_tensor(self.current_MAP, dtype=torch.float32, device=self.device)
        z = self.normalize_input(self.apply_transform(torch.atleast_2d(x)))[0].clone()
        z[self.diag_order[index]] = var
        back = self.reverse_transform(self.denormalize_input(torch.atleast_2d(z)))
        return float(back[0][index])

    def _column(self, fn, col: torch.Tensor) -> torch.Tensor:
        """A user transform of one column, called on the host with a numpy
        column (as the model gets numpy rows), back as float32 on the
        wrapper's device."""
        if fn is _identity:
            return col
        out = fn(col.cpu().numpy())
        return torch.as_tensor(np.asarray(out, np.float32)).to(self.device)

    def apply_transform(self, x):
        return torch.stack([self._column(self.transforms[i][0], x[..., i])
                            for i in range(self.input_dim)], dim=-1)

    def reverse_transform(self, x):
        return torch.stack([self._column(self.transforms[i][1], x[..., i])
                            for i in range(self.input_dim)], dim=-1)

    # -- objective evaluation ------------------------------------------------

    def evaluate_model(self, x):
        """Denormalize, reverse-transform and call the black-box model
        (SOBER/_sober_wrapper.py:527-577): with the tensor batch under
        disable_numpy_mode, else on numpy rows, once for the whole batch or,
        with parallelization, once a row in a process pool."""
        batch = self.reverse_transform(self.denormalize_input(torch.atleast_2d(x)))
        if self.disable_numpy_mode:
            return torch.as_tensor(self.model(batch, **self.model_kwargs),
                                   dtype=torch.float32, device=self.device)
        batch_np = batch.cpu().numpy()
        if self.parallelization:
            args = [(self.model, row, self.model_kwargs) for row in batch_np]
            with Pool() as pool:
                evaluations = pool.map(_eval_one, args)
            out = np.stack(evaluations)
        else:
            out = np.asarray(self.model(batch_np, **self.model_kwargs))
        return torch.as_tensor(out, dtype=torch.float32, device=self.device)

    def distance_function(self, observations):
        """The weighted 2-norm distance to the data (SOBER/_sober_wrapper.py:493-506)."""
        diff = (observations - self.data) * self.weights
        return torch.linalg.norm(diff.reshape(observations.shape[0], -1), dim=1)

    def default_objective_function(self, observations):
        """-log distance (SOBER/_sober_wrapper.py:508-525)."""
        return -torch.log(torch.clamp_min(self.distance_function(observations), 1e-38))

    def objective_and_loglikelihood_function(self, x, sober_batch=True):
        """(objective, loglikelihood) at normalized x
        (SOBER/_sober_wrapper.py:579-609)."""
        if self.custom_objective_and_loglikelihood is not None:
            batch = self.reverse_transform(self.denormalize_input(torch.atleast_2d(x)))
            obj, ll = self.custom_objective_and_loglikelihood(batch)
            f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=self.device)
            return f32(obj), f32(ll)
        evaluations = self.evaluate_model(x)
        if not self.standalone:
            self.process_evaluations(evaluations, sober_batch)
        n = self.input_dim
        objective = self.default_objective_function(evaluations)
        if self.maximize:
            objective = -objective
        loglikelihood = -0.5 * (1 + math.log(2 * math.pi / n) - objective) * n
        return objective, loglikelihood

    def process_evaluations(self, evaluations, sober_batch):
        """A hook for subclasses that are not standalone
        (SOBER/_sober_wrapper.py:352-362)."""

    # -- surrogate -----------------------------------------------------------

    def set_rbf_model(self, x, y, use_bolfi=False):
        """The ARD-RBF or BOLFI surrogate (SOBER/_sober_wrapper.py:611-638),
        fit cold each time: EP retargets it at another site's objective
        every visit, and carried hypers hurt its recovery there."""
        if use_bolfi:
            self.surrogate_model = make_bolfi_model(x, y, self.bounds)
        else:
            cfg = GPConfig(ard=True, noise_lo=1e-2, noise_hi=10.0,
                           standardize_y=False, use_priors=False)
            self.surrogate_model = fit_gp(x, y, cfg)

    def optimize_model(self):
        """Refit the surrogate on all data (SOBER/_sober_wrapper.py:640-652)."""
        self.set_rbf_model(self.X_all, self.Y_all, use_bolfi=self.use_bolfi)

    def initialize_sober(self):
        """(SOBER/_sober_wrapper.py:315-350)"""
        self.Y_all, self.LL_all = self.objective_and_loglikelihood_function(
            self.X_all, sober_batch=True)
        self.Y_all_mean = self.Y_all.mean()
        self.Y_all_std = torch.clamp_min(self.Y_all.std(), 1e-12)
        self.Y_all = (self.Y_all - self.Y_all_mean) / self.Y_all_std
        if self.visualizations and self.Y_all.shape[0]:
            self.visualize_objective_histograms()
        self.set_rbf_model(self.X_all, self.Y_all, use_bolfi=self.use_bolfi)
        self.sober = Sober(self.prior, self.surrogate_model)
        self.results = []
        self.total_sober_iterations = 0
        self.total_model_samples = []

    # -- results -------------------------------------------------------------

    def results_to_dict(self):
        """(SOBER/_sober_wrapper.py:676-692)"""
        host = lambda t: t.detach().cpu().numpy()
        return {
            "parameters evaluations": [list(map(float, row)) for row in host(self.X_all)],
            "objective evaluations": list(map(float, host(
                self.Y_all_mean + self.Y_all_std * self.Y_all))),
            "Log-Likelihood evaluations": list(map(float, host(self.LL_all))),
            "results": {
                "duration [s]": [r[0] for r in self.results],
                "best observed": [r[1] for r in self.results],
            },
        }

    def save_state(self, path: str):
        """Checkpoint the loop state (X, Y, LL, the normalization, the
        random state); the reference has no persistence."""
        from ..utils.checkpoint import save_checkpoint

        save_checkpoint(path, {
            "x_all": self.X_all, "y_all": self.Y_all, "ll_all": self.LL_all,
            "y_mean": self.Y_all_mean, "y_std": self.Y_all_std,
            "key": self.keys._gen.get_state(),
        }, metadata={"sober_iterations": self.sober_iterations,
                     "results": self.results,
                     "total_sober_iterations": self.total_sober_iterations,
                     "total_model_samples": self.total_model_samples})

    def load_state(self, path: str):
        """Resume from a save_state checkpoint and refit the surrogate."""
        from ..utils.checkpoint import load_loop_state

        state, meta = load_loop_state(path, device=self.device)
        self.X_all = state["x_all"]
        self.Y_all = state["y_all"]
        self.LL_all = state["ll_all"]
        self.Y_all_mean = state["y_mean"]
        self.Y_all_std = state["y_std"]
        self.keys._gen.set_state(state["key"])
        self.sober_iterations = meta["sober_iterations"]
        self.results = [list(r) for r in meta["results"]]
        # the counters resume too, or visualize_results would plot lists of
        # different lengths; a checkpoint without them rebuilds them
        self.total_sober_iterations = int(meta.get("total_sober_iterations",
                                                   len(self.results)))
        self.total_model_samples = [int(v) for v in meta.get(
            "total_model_samples", range(1, len(self.results) + 1))]
        self.set_rbf_model(self.X_all, self.Y_all, use_bolfi=self.use_bolfi)
        self.sober = Sober(self.prior, self.surrogate_model)

    def visualize_prior(self):
        """A scatter matrix of the initial prior draws (matplotlib, in place
        of the seaborn pairplot at SOBER/_sober_wrapper.py:296-305)."""
        import matplotlib.pyplot as plt

        d = self.input_dim
        x = self.X_all.cpu().numpy()
        fig, axes = plt.subplots(d, d, figsize=(2 * d, 2 * d), tight_layout=True)
        axes = np.atleast_2d(axes)
        for i in range(d):
            for j in range(d):
                if i == j:
                    axes[i][j].hist(x[:, i], 30)
                else:
                    axes[i][j].scatter(x[:, j], x[:, i], s=4)
        fig.suptitle("correlation plot of prior sampling")
        plt.show()

    def visualize_objective_histograms(self):
        """Objective and log-likelihood histograms, drawn when
        initialize_sober runs with visualizations=True
        (SOBER/_sober_wrapper.py:328-343)."""
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(1, 2, tight_layout=True, figsize=(8, 4))
        y = (self.Y_all_mean + self.Y_all_std * self.Y_all).cpu().numpy()
        ax[0].hist(y, 50)
        if self.custom_objective_and_loglikelihood is None:
            ax[0].set_title("log distances histogram")
            ax[0].set_xlabel("log distance values")
        else:
            ax[0].set_title("custom objective histogram")
            ax[0].set_xlabel("custom objective values")
        ax[0].set_ylabel("occurrences")
        ax[1].hist(self.LL_all.cpu().numpy(), 50)
        ax[1].set_title("log likelihoods histogram")
        ax[1].set_xlabel("log likelihood values")
        plt.show()
        return fig

    def map_vs_best_table(self, basq, map_normalized, map_params,
                          best_norm, best_observed, verbose: bool = True):
        """The MAP against the best observation: parameters (in the caller's
        space), BASQ's posterior density and the log-likelihood
        (SOBER/_sober_wrapper.py:946-969, with a fixed-width table in place
        of tabulate). Returns the rows."""
        rows = [["Location", "Parameters", "Posterior", "Log-Likelihood"]]
        for name, norm, params in (("MAP", map_normalized, map_params),
                                   ("best observed", best_norm, best_observed)):
            post = float(basq.posterior(torch.atleast_2d(norm))[0])
            ll = float(torch.atleast_1d(self.objective_and_loglikelihood_function(
                torch.atleast_2d(norm), sober_batch=False)[1])[0])
            rows.append([name, np.array2string(params.cpu().numpy(), precision=4),
                         f"{post:.4e}", f"{ll:.4e}"])
        if verbose:
            widths = [max(len(str(r[c])) for r in rows) for c in range(4)]
            sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
            print(sep)
            for k, r in enumerate(rows):
                print("| " + " | ".join(str(v).ljust(w) for v, w in zip(r, widths)) + " |")
                if k == 0:
                    print(sep)
            print(sep)
        return rows

    def visualize_posterior(self, taken_samples):
        """The posterior pairplot, re-ordered to the parameters' order by
        diag_order, its edge ticks in the caller's space and the true
        optimum (when given) starred on the diagonal
        (SOBER/_sober_wrapper.py:971-1015)."""
        import matplotlib.pyplot as plt
        from matplotlib.ticker import FuncFormatter

        d = self.input_dim
        s = taken_samples.cpu().numpy()
        orig = np.zeros_like(s)
        for par_index, raw_index in enumerate(self.diag_order):
            orig[:, par_index] = s[:, raw_index]
        fig, axes = plt.subplots(d, d, figsize=(2.2 * d, 2.2 * d), tight_layout=True)
        axes = np.atleast_2d(axes)
        for i in range(d):
            for j in range(d):
                if i == j:
                    axes[i][j].hist(orig[:, i], 30, density=True)
                else:
                    axes[i][j].scatter(orig[:, j], orig[:, i], s=4, alpha=0.5)
        for i in range(d):
            fmt = FuncFormatter(lambda x, _, index=i: "{:.3g}".format(
                self.denormalize_and_reverse_transform_one_variable(x, index)))
            axes[d - 1][i].xaxis.set_major_formatter(fmt)
            axes[i][0].yaxis.set_major_formatter(fmt)
            plt.setp(axes[i][0].get_yticklabels(), rotation=45, ha="right",
                     rotation_mode="anchor")
            plt.setp(axes[d - 1][i].get_xticklabels(), rotation=45, ha="right",
                     rotation_mode="anchor")
        if self.normalized_true_optimum is not None:
            for i in range(len(self.true_optimum)):
                axes[i][i].scatter(float(self.normalized_true_optimum[i]), 0.0, s=100,
                                   marker="*", color="tab:orange")
        plt.show()
        return fig

    def visualize_results(self):
        """(SOBER/_sober_wrapper.py:654-674)"""
        import matplotlib.pyplot as plt

        _, ax = plt.subplots(1, 2, tight_layout=True, figsize=(8, 4))
        ax[0].plot(self.total_model_samples, [r[1] for r in self.results], "bo-",
                   label="observed maximum")
        ax[0].legend()
        ax[0].set_xlabel("index of batches")
        ax[0].set_ylabel("objective")
        ax[1].plot(self.total_model_samples, [r[0] for r in self.results], "bo-")
        ax[1].set_xlabel("index of batches")
        ax[1].set_ylabel("overhead [s]")
        plt.show()

    # -- main loops ----------------------------------------------------------

    def run_SOBER(self, sober_iterations: int, model_samples_per_iteration: int,
                  surrogate_samples: Optional[int] = None,
                  surrogate_effective_samples: Optional[int] = None,
                  acquisition_function=None, visualizations: bool = False,
                  verbose: bool = True, polish: bool = False, **kwargs):
        """The SOBER loop (SOBER/_sober_wrapper.py:694-821): each iteration
        refits the surrogate, runs next_batch(surrogate_samples,
        surrogate_effective_samples, model_samples_per_iteration) with
        BOLFI's UCB as calc_obj under use_bolfi, evaluates the batch and
        renormalizes the objectives. `polish` is Sober.next_batch's exploit
        polish."""
        surrogate_effective_samples = (surrogate_effective_samples
                                       or 2 * model_samples_per_iteration)
        if model_samples_per_iteration >= surrogate_effective_samples:
            raise ValueError("Number of model evaluations must be lower than number "
                             "of surrogate evaluations.")
        surrogate_samples = surrogate_samples or 4 * model_samples_per_iteration

        for _ in range(sober_iterations):
            self.sober_iterations += 1
            t0 = time.monotonic()
            self.optimize_model()
            self.sober.update_model(self.surrogate_model)
            if acquisition_function is None and self.use_bolfi:
                acquisition_function = SOBERUCB(self.surrogate_model,
                                                sample_size=len(self.X_all))
            x_batch = self.sober.next_batch(
                surrogate_samples, surrogate_effective_samples,
                model_samples_per_iteration, calc_obj=acquisition_function,
                verbose=verbose, polish=polish)
            self.surrogate_effective_samples = surrogate_effective_samples
            t1 = time.monotonic()

            self.X_all = torch.cat([self.X_all, x_batch])
            y_batch, ll_batch = self.objective_and_loglikelihood_function(
                x_batch, sober_batch=True)
            # de-normalize, append, re-normalize (SOBER/_sober_wrapper.py:791-798)
            y_all = torch.cat([self.Y_all_mean + self.Y_all_std * self.Y_all, y_batch])
            self.Y_all_mean = y_all.mean()
            self.Y_all_std = torch.clamp_min(y_all.std(), 1e-12)
            self.Y_all = (y_all - self.Y_all_mean) / self.Y_all_std
            self.LL_all = torch.cat([self.LL_all, ll_batch])

            best = float(y_all.max())
            if verbose:
                dt = t1 - t0
                print(f"{len(self.X_all)}) Best objective: {best:.5e} "
                      f"Best Log-Likelihood: {float(self.LL_all.max()):.5e}")
                print(f"Acquisition time [s]: {dt:.5e}, per sample [ms]: "
                      f"{dt / model_samples_per_iteration * 1e3:.5e}")
            self.results.append([t1 - t0, best])
            self.total_sober_iterations += 1
            prev = self.total_model_samples[-1] if self.total_model_samples else 0
            self.total_model_samples.append(prev + model_samples_per_iteration)

        if visualizations:
            self.visualize_results()

    def run_BASQ(self, integration_nodes: int, basq_samples: Optional[int] = None,
                 basq_effective_samples: Optional[int] = None,
                 basq_posterior_samples: Optional[int] = None,
                 map_samples: Optional[int] = None, dampening: float = 0.0,
                 visualizations: bool = False, return_raw_samples: bool = False,
                 verbose: bool = True, **kwargs):
        """The evidence and posterior by BASQ (SOBER/_sober_wrapper.py:823-1025).
        Returns (posterior samples, MAP, best observed, ELML, AVLML)."""
        map_samples = map_samples or max(
            self.sober_iterations * self.surrogate_effective_samples, 1)
        if map_samples < self.surrogate_effective_samples:
            raise ValueError("Number of MAP samples must be higher than number of "
                             "surrogate effective samples.")
        basq_samples = basq_samples or 4 * integration_nodes
        basq_effective_samples = basq_effective_samples or 2 * integration_nodes
        basq_posterior_samples = basq_posterior_samples or integration_nodes

        t0 = time.monotonic()
        basq_model = ScaleMmltGP(self.X_all, self.LL_all)
        t_setup = time.monotonic()
        basq = BASQ(self.prior, basq_model, self.sober, ratio_wkde=1.0 - dampening,
                    verbose=verbose)
        t_init = time.monotonic()
        elml, avlml = basq.quadrature(basq_samples, basq_effective_samples,
                                      integration_nodes)
        t_quad = time.monotonic()
        taken_samples = basq.sampling_posterior(basq_posterior_samples)
        t_samp = time.monotonic()
        map_normalized = basq.MAP(map_samples)
        t_map = time.monotonic()
        if verbose:
            print("BASQ: setup", t_setup - t0, "init", t_init - t_setup,
                  "quad", t_quad - t_init, "samples", t_samp - t_quad,
                  "MAP", t_map - t_samp)

        map_params = self.reverse_transform(self.denormalize_input(
            torch.atleast_2d(map_normalized)))[0]
        self.current_MAP = map_params
        y_all = self.Y_all_mean + self.Y_all_std * self.Y_all
        best_norm = self.X_all[int(torch.argmax(y_all))]
        best_observed = self.reverse_transform(self.denormalize_input(
            torch.atleast_2d(best_norm)))[0]

        # the posterior diagnostics (SOBER/_sober_wrapper.py:946-1015)
        if verbose:
            self.map_vs_best_table(basq, map_normalized, map_params, best_norm,
                                   best_observed)
        if visualizations or self.visualizations:
            self.visualize_posterior(taken_samples)

        samples_out = (taken_samples if return_raw_samples else
                       self.reverse_transform(self.denormalize_input(taken_samples)))
        return samples_out, map_params, best_observed, elml, avlml

    def run_SOBER_adaptively(self, stopping_criterion_variance: float = 0.1,
                             adaptive_batchsize_tolerance: float = 0.1,
                             sober_iterations_per_convergence_check: int = 1,
                             maximum_number_of_batches: int = 10, **kwargs):
        """SOBER batch by batch until BASQ's evidence variance falls below
        the criterion (SOBER/_sober_wrapper.py:1027-1070, with its
        kwargs.get['sober_iterations'] at :1062 read as kwargs.get(...))."""
        if kwargs.get("sober_iterations"):
            maximum_number_of_batches = kwargs["sober_iterations"]
        kwargs["sober_iterations"] = 1
        for n_iter in range(maximum_number_of_batches):
            self.run_SOBER(**kwargs)
            if not n_iter % sober_iterations_per_convergence_check:
                *_, log_variance = self.run_BASQ(**kwargs)
                if math.exp(log_variance) < stopping_criterion_variance:
                    break

