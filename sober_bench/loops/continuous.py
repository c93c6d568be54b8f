"""The continuous batch-BO campaign: the body of
examples_torch/common.py:run_bo_loop, frozen here (fit_gp_padded ->
Sober.update_model -> Sober.next_batch -> the objective on the host -> the
batch appended), and its check against the float64 reference."""
from __future__ import annotations

import types

import numpy as np
import torch

from sober_bench import probe as pr
from sober_bench import reference as ref


class Loop:
    """One configuration's campaign on `device`: `start` makes an episode,
    then each round is `fit`, `update`, `next_batch`, `observe`."""

    def __init__(self, config: dict, traffic: dict, device, module):
        from sober_tpu_torch.gp.exact import GPConfig

        gp = config["gp"]
        self.gp, self.traffic, self.device = gp, traffic, device
        self.gp_cfg = GPConfig(kernel_name=gp["kernel"], noise_lo=gp["noise_lo"],
                               noise_hi=gp["noise_hi"], fit_iters=gp["fit_iters"],
                               fit_lr=gp["fit_lr"])
        self.spec = ref.FitSpec.of(gp)
        self.kernel_type = config["kernel_type"]
        self.fit_span = "fit." + config["fit_entry"]
        self.bounds = torch.tensor(config["domain"]["bounds"], dtype=torch.float32,
                                   device=device)
        self.objective = module.objective

    def evaluate(self, x: torch.Tensor) -> torch.Tensor:
        """The user's black box: the batch to the host, the objective there,
        the values back to the device."""
        y = self.objective(x.detach().cpu().numpy().astype(np.float64))
        return torch.as_tensor(np.asarray(y, np.float32), device=self.device)

    def start(self, seed: int, probe: pr.Probe):
        """An episode: n_init points of a Uniform prior whose Sobol stream
        `seed` scrambles, their values, the first fit and a new Sober."""
        from sober_tpu_torch import Sober
        from sober_tpu_torch.priors import Uniform

        prior = Uniform(self.bounds, seed=seed, device=self.device)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        x = prior.sample(gen, self.traffic["n_init"])
        ep = types.SimpleNamespace(x=x, y=self.evaluate(x))
        ep.sober = Sober(prior, self.fit(ep), seed=seed, kernel_type=self.kernel_type)
        pr.watch_recombination(ep.sober, probe)
        return ep

    def fit(self, ep):
        from sober_tpu_torch.gp.exact import fit_gp_padded

        return fit_gp_padded(ep.x, ep.y, self.gp_cfg, optimiser=self.gp["optimiser"],
                             bucket=self.gp["bucket"])

    def update(self, ep, model, probe: pr.Probe) -> None:
        if probe.record is not None:
            # the proposal the round draws its first pool from, unless the
            # round resets it to the domain prior
            probe.record["proposal_before"] = ep.sober.prior
        ep.sober.update_model(model)
        if probe.record is not None and probe.record["answers"]:
            # the pi calls stay on the device until the check, and only a
            # round whose answers it compares reads them
            pr.watch_pi(ep.sober, probe)

    def next_batch(self, ep):
        t = self.traffic
        return ep.sober.next_batch(t["n_rec"], t["n_nys"], t["batch"])

    def observe(self, ep, out) -> None:
        ep.x = torch.cat([ep.x, out])
        ep.y = torch.cat([ep.y, self.evaluate(out)])

    def keep(self, ep, model, out, record: dict) -> None:
        """What the check of a recorded round reads, besides the pi calls
        and the recombination: the observations the fit saw, the fitted
        hypers, whether the round reset the proposal, the proposal the
        round fitted, the batch."""
        kp = model.kernel.params
        record.update(x_obs=ep.x, y_obs=ep.y, batch=out, proposal=ep.sober.prior,
                      reset=bool(ep.sober.last_reset),
                      hypers={"ls": kp["lengthscale"], "os": kp["outputscale"],
                              "noise": model.noise})

    # -- the check -----------------------------------------------------------

    def judge(self, rec: dict) -> dict:
        """The round's numbers against the reference (PERF.md section 4):
        fit_loss_gap and batch_faults on every checked round; where the
        record asks for the answers (rec["answers"]), also pi_gap and pi_tv
        on the pool, weight_tv, and moment_gap (on all test functions and
        on the top ones).
        weight_tv is worked out where the round's first pool was drawn from
        the domain prior (an episode's first round, or a round that reset
        the proposal), so that the reference derives the proposal's density
        from its own weights; a number a round cannot give is left out."""
        t, spec = self.traffic, self.spec
        lo, hi = self.bounds[0], self.bounds[1]
        h = {k: v.double() for k, v in rec["hypers"].items()}
        h_ref, problem, _ = ref.fit(rec["x_obs"], rec["y_obs"], spec)
        loss_ref = ref.loss_at(h_ref, problem, spec)
        out = {"fit_loss_gap": max(0.0, ref.loss_at(h, problem, spec) - loss_ref)
               / max(abs(loss_ref), 1.0)}
        rc = rec["recombination"]
        x_cand, weights, idx, w = rc["x_cand"], rc["weights"], rc["idx"], rc["w"]
        calls = rec.get("pi_calls", [])
        xb = rec["batch"]
        in_range = bool(((idx >= 0) & (idx < x_cand.shape[0])).all())
        faults = [
            tuple(xb.shape) != (t["batch"], lo.shape[0]),
            idx.shape[0] != t["batch"] or w.shape[0] != t["batch"],
            not bool(torch.isfinite(xb).all()),
            not bool(((xb >= lo) & (xb <= hi)).all()),
            int(torch.unique(idx).numel()) != idx.numel(),
            not in_range,
            not in_range or not bool(torch.equal(xb, x_cand[idx])),
            bool((w < 0).any()),
            abs(float(torch.sum(w.double())) - 1.0) > 1e-5,
        ]
        out["batch_faults"] = float(sum(faults))
        if not rec["answers"]:
            return out
        if not calls:
            out["batch_faults"] += 1.0
            return out
        post = ref.Posterior(rec["x_obs"], rec["y_obs"], h, spec)
        # the pi call that made the pool's weights, where no refill round
        # replaced rows of it; else the round's first draw
        pool_call = next(((x, p) for x, p in calls if x is x_cand), None)
        x_pi, p_port = pool_call or calls[0]
        p_ref = post.pi(x_pi)
        out["pi_gap"] = float(torch.max(torch.abs(p_port.double() - p_ref)))
        out["pi_tv"] = ref.pi_tv(p_port, p_ref)
        uniform = bool(torch.all(weights == weights[0]))
        from_prior = rec["reset"] or not hasattr(rec["proposal_before"], "covariance")
        x0 = calls[0][0]
        if (pool_call is not None and x_pi is not x0 and not uniform and from_prior
                and hasattr(rec["proposal"], "covariance")):
            # the first pool's weights under the domain prior, the proposal
            # fitted to them on the components its draw picked, then the
            # pool's weights, cleansed when drawn and again when the refill
            # hands them on (SOBER/_sampler.py:205-261)
            w0 = ref.cleanse(post.pi(x0) / ref.uniform_pdf(x0, lo, hi))
            centers = rec["proposal"].x_obs
            fitted = ref.wkde_fit(x0, w0, centers)
            if fitted is not None:
                pdf = ref.wkde_pdf(centers, *fitted, lo, hi, x_cand)
                w_ref = ref.cleanse(ref.cleanse(p_ref / torch.clamp_min(pdf, 1e-300)))
                out["weight_tv"] = float(torch.sum(torch.abs(weights.double() - w_ref)))
        if in_range:
            cov = lambda a, b: post.covariance(a, b, weighted=False)
            out["moment_gap"], out["moment_gap_top"] = ref.moment_gap(
                cov, x_cand, rc["x_nys"], weights, idx, w, t["batch"] - 1)
        return out
