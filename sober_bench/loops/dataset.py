"""The dataset-domain screening campaign: the body of
examples_torch/common.py:run_dataset_loop, frozen here (fit_tanimoto_gp ->
Sober.update_model -> Sober.next_batch -> the batch's rows queried and
consumed -> appended), and its check against the float64 reference. The
pool is restored for each episode."""
from __future__ import annotations

import types

import torch

from sober_bench import probe as pr
from sober_bench import reference as ref


class Loop:
    def __init__(self, config: dict, traffic: dict, device, module):
        gp = config["gp"]
        self.gp, self.traffic, self.device = gp, traffic, device
        self.spec = ref.FitSpec.of(gp)
        self.kernel_type = config["kernel_type"]
        self.prune_thresh = config["prune_thresh"]
        self.fit_span = "fit." + config["fit_entry"]
        self.features, self.targets = module.load(config, device,
                                                  traffic.get("n_pool"))

    def start(self, seed: int, probe: pr.Probe):
        """An episode: the whole pool available again, n_init rows drawn
        and consumed, the first fit and a new Sober."""
        from sober_tpu_torch import DatasetPrior, Sober

        prior = DatasetPrior(self.features, self.targets, device=self.device)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        x, y = prior.sample(gen, self.traffic["n_init"])
        ep = types.SimpleNamespace(x=x, y=y, prior=prior)
        ep.sober = Sober(prior, self.fit(ep), seed=seed, kernel_type=self.kernel_type)
        pr.watch_recombination(ep.sober, probe)
        return ep

    def fit(self, ep):
        from sober_tpu_torch import fit_tanimoto_gp

        gp = self.gp
        return fit_tanimoto_gp(ep.x, ep.y, noise_lo=gp["noise_lo"],
                               noise_hi=gp["noise_hi"], optimiser=gp["optimiser"],
                               fit_iters=gp["fit_iters"], bucket=gp["bucket"])

    def update(self, ep, model, probe: pr.Probe) -> None:
        if probe.record is not None:
            # the rows still available when the round chose its pool
            probe.record["available"] = ep.prior.available.clone()
        ep.sober.update_model(model)
        pr.watch_pi(ep.sober, probe)

    def next_batch(self, ep):
        t = self.traffic
        return ep.sober.next_batch(t["n_rec"], t["n_nys"], t["batch"])

    def observe(self, ep, out) -> None:
        idx, x_batch = out
        ep.x = torch.cat([ep.x, x_batch])
        ep.y = torch.cat([ep.y, ep.prior.query(idx)])

    def keep(self, ep, model, out, record: dict) -> None:
        record.update(x_obs=ep.x, y_obs=ep.y, batch=out,
                      hypers={"os": model.kernel.params["outputscale"],
                              "noise": model.noise})

    # -- the check -----------------------------------------------------------

    def judge(self, rec: dict) -> dict:
        """The round's numbers against the reference (PERF.md section 4):
        fit_loss_gap, pi_gap, weight_tv, moment_gap (on all test functions
        and on the top ones) and batch_faults."""
        t, spec, feats = self.traffic, self.spec, self.features
        h = {k: v.double() for k, v in rec["hypers"].items()}
        h_ref, problem, gram = ref.fit(rec["x_obs"], rec["y_obs"], spec)
        loss_ref = ref.loss_at(h_ref, problem, spec, gram)
        out = {"fit_loss_gap": max(0.0, ref.loss_at(h, problem, spec, gram) - loss_ref)
               / max(abs(loss_ref), 1.0)}
        post = ref.Posterior(rec["x_obs"], rec["y_obs"], h, spec)

        avail = rec["available"]
        calls = [(x, p) for x, p in rec.get("pi_calls", []) if x is feats]
        faults = [not calls]
        if calls:
            p_port = calls[0][1].double()
            p_ref = post.pi(feats)
            out["pi_gap"] = float(torch.max(torch.abs(p_port - p_ref)[avail]))
        rc = rec["recombination"]
        x_cand, weights, idx, w = rc["x_cand"], rc["weights"], rc["idx"], rc["w"]
        if calls:
            # the pool the program pruned to, from its own pi: the n_rec
            # largest weights of the available rows, ties to the lower row
            scores = torch.where(avail, p_port, 0.0)
            rows = ref.top_k(scores, t["n_rec"])
            same_pool = (rows.numel() == x_cand.shape[0]
                         and bool(torch.equal(feats[rows], x_cand)))
            faults.append(not same_pool)
            if same_pool:
                rank = torch.arange(rows.numel(), device=rows.device)
                keep = (scores[rows] > self.prune_thresh) | (rank < t["n_nys"])
                w_ref = ref.cleanse(torch.where(keep, p_ref[rows], 0.0))
                out["weight_tv"] = float(torch.sum(torch.abs(weights.double() - w_ref)))
                idx_global, x_batch = rec["batch"]
                in_range = bool(((idx >= 0) & (idx < rows.numel())).all())
                faults += [not in_range
                           or not bool(torch.equal(idx_global, rows[idx]))]
        cov = lambda a, b: post.covariance(a, b, weighted=True)
        out["moment_gap"], out["moment_gap_top"] = ref.moment_gap(
            cov, x_cand, rc["x_nys"], weights, idx, w, t["batch"] - 1)
        idx_global, x_batch = rec["batch"]
        faults += [
            idx_global.shape[0] != t["batch"] or idx.shape[0] != t["batch"],
            int(torch.unique(idx_global).numel()) != idx_global.numel(),
            not bool(avail[idx_global].all()),
            not bool(torch.equal(x_batch, feats[idx_global])),
            bool((w < 0).any()),
            abs(float(torch.sum(w.double())) - 1.0) > 1e-5,
        ]
        out["batch_faults"] = float(sum(faults))
        return out
