"""The plain reference of a SOBER round, in float64 arithmetic (plain
PyTorch only).

It imports nothing of the program. From the inputs that the benchmark made
(observations, pools, fingerprints) and the program's outputs that are judged
(hypers, pi values, weights, batches), it works out again what the round
derived: the GP fit (the MAP objective and its optimiser, replayed), the
posterior, pi, the weighted-KDE density, the importance weights and the
moments that kernel recombination must match. The semantics are those of
the reference SOBER (arXiv:2404.12219; SOBER/_gp.py, _pi.py, _wkde.py,
_weights.py, _sampler.py, _rchq.py) as the configuration states them.

The configuration computes in float32, where a Gram of observations that
a campaign has packed near its optimum does not factor: there it adds
jitter (a 1e-2 retry in the fit's objective, a ladder of tens in the
posterior). Those decisions belong to the configuration's semantics. So
the fit is replayed in float32 (TF32 off), the configuration's precision:
in float64 it would optimise another function. The posterior and
everything after it are computed in float64 with the jitter that float32
needs, decided from the reference's own Gram. Everything runs in blocks of
rows, on whatever device the tensors are on.
"""
from __future__ import annotations

import dataclasses
import math

import torch

F64 = torch.float64
# the configuration's precision, in which the fit is replayed
FIT_DTYPE = torch.float32
# the weight-cleansing threshold, float32's epsilon (SOBER/_weights.py:7)
EPS32 = float(torch.finfo(torch.float32).eps)
BLOCK = 16_384
# the test functions of largest eigenvalue whose moments moment_gap also
# compares alone
TOP = 10


# ----------------------------------------------------------------------------
# kernels
# ----------------------------------------------------------------------------

def rbf(x, y, ls, os_):
    """os * exp(-||x - y||^2 / (2 ls^2)); differentiable in ls and os."""
    xs, ys = x / ls, y / ls
    d2 = (torch.sum(xs * xs, 1)[:, None] + torch.sum(ys * ys, 1)[None, :]
          - 2.0 * (xs @ ys.T))
    return os_ * torch.exp(-0.5 * torch.clamp_min(d2, 0.0))


def tanimoto(x, y, ls, os_):
    """os * <x,y> / (|x|^2 + |y|^2 - <x,y>) of 0/1 rows (exact in float64)."""
    xy = x @ y.T
    nx, ny = torch.sum(x * x, 1), torch.sum(y * y, 1)
    return os_ * xy / torch.clamp_min(nx[:, None] + ny[None, :] - xy, 1e-20)


KERNELS = {"rbf": rbf, "tanimoto": tanimoto}


@dataclasses.dataclass(frozen=True)
class FitSpec:
    """The GP of a configuration: kernel, noise interval, optimiser and its
    budget, observation bucket (SOBER/_gp.py; examples/*.py)."""
    kernel: str
    noise_lo: float
    noise_hi: float
    fit_iters: int
    fit_lr: float
    optimiser: str
    bucket: int

    @classmethod
    def of(cls, gp: dict) -> "FitSpec":
        return cls(gp["kernel"], gp["noise_lo"], gp["noise_hi"], gp["fit_iters"],
                   gp["fit_lr"], gp["optimiser"], gp["bucket"])


# ----------------------------------------------------------------------------
# the MAP fit, replayed in the configuration's precision
# ----------------------------------------------------------------------------

def _inv_softplus(y):
    return y + torch.log(-torch.expm1(-y))


def _inv_interval(v, lo, hi):
    p = torch.clamp((v - lo) / (hi - lo), 1e-6, 1 - 1e-6)
    return torch.log(p) - torch.log1p(-p)


def pad(x, y, bucket: int):
    """(x, y) padded with zero rows to the next multiple of bucket, and the
    mask of real rows."""
    n = x.shape[0]
    extra = -(-n // bucket) * bucket - n
    mask = torch.cat([x.new_ones(n), x.new_zeros(extra)])
    return (torch.cat([x, x.new_zeros((extra, x.shape[1]))]),
            torch.cat([y, y.new_zeros(extra)]), mask)


def masked_stats(y, mask):
    n = torch.clamp_min(torch.sum(mask), 2.0)
    mean = torch.sum(y * mask) / n
    var = torch.sum(((y - mean) * mask) ** 2) / (n - 1.0)
    return mean, torch.clamp_min(torch.sqrt(var), 1e-12)


def hypers(raw: dict, spec: FitSpec) -> dict:
    """Raw parameters -> lengthscale, outputscale, noise variance."""
    sp = torch.nn.functional.softplus
    return {"ls": sp(raw["ls"]), "os": sp(raw["os"]),
            "noise": spec.noise_lo + (spec.noise_hi - spec.noise_lo) * torch.sigmoid(raw["noise"])}


def raw_of(h: dict, spec: FitSpec) -> dict:
    lo, hi = spec.noise_lo, spec.noise_hi
    noise = torch.clamp(h["noise"], lo + 1e-9 * (hi - lo), hi - 1e-9 * (hi - lo))
    # a kernel without a lengthscale (Tanimoto) leaves it at its start
    ls = h["ls"] if "ls" in h else torch.log(torch.tensor(2.0, dtype=noise.dtype))
    return {"ls": _inv_softplus(torch.clamp_min(ls.to(noise.device), 1e-20)),
            "os": _inv_softplus(torch.clamp_min(h["os"], 1e-20)),
            "noise": _inv_interval(noise, lo, hi)}


def initial_raw(spec: FitSpec, device, dtype=F64) -> dict:
    """The optimiser's start: lengthscale softplus(0), outputscale 1, noise
    the geometric mean of its interval."""
    f = lambda v: torch.tensor(v, dtype=dtype, device=device)
    lo, hi = spec.noise_lo, spec.noise_hi
    return {"ls": f(0.0), "os": _inv_softplus(f(1.0)),
            "noise": _inv_interval(torch.sqrt(f(lo * hi)), lo, hi)}


def _masked_gram(k, noise, mask):
    k = k * (mask[:, None] * mask[None, :])
    return k + noise * torch.diag(mask) + torch.diag(1.0 - mask)


def neg_mll(raw: dict, x, y, mask, spec: FitSpec, gram=None):
    """Negative marginal log likelihood per real datum of the zero-mean GP on
    a padded buffer (padding rows are unit diagonal rows that add nothing),
    with the fixed 1e-5 relative jitter of the configuration's objective and
    its one retry at 1e-2 where that matrix does not factor, in the dtype of
    x. `gram` is the kernel's Gram without its outputscale when it does not
    depend on a lengthscale."""
    h = hypers(raw, spec)
    k = (h["os"] * gram if gram is not None
         else KERNELS[spec.kernel](x, x, h["ls"], h["os"]))
    k = _masked_gram(k, h["noise"], mask)
    n = torch.sum(mask)
    resid = y * mask
    scale = torch.mean(torch.diagonal(k))
    eye = torch.eye(k.shape[0], dtype=k.dtype, device=k.device)
    a = k + 1e-5 * scale * eye
    a = 0.5 * (a + a.T)
    chol, info = torch.linalg.cholesky_ex(a.detach())
    if int(info) > 0 or bool(torch.isnan(torch.diagonal(chol)).any()):
        a = a + (1e-2 - 1e-5) * scale * eye
    chol, _ = torch.linalg.cholesky_ex(a)
    alpha = torch.cholesky_solve(resid[:, None], chol)[:, 0]
    mll = (-0.5 * (resid @ alpha) - torch.sum(torch.log(torch.diagonal(chol)) * mask)
           - 0.5 * n * math.log(2.0 * math.pi))
    mll = torch.where(torch.isfinite(mll), mll, torch.full_like(mll, -1e10))
    return -mll / n


def _detach(raw):
    return {k: v.detach().clone() for k, v in raw.items()}


def _plateau(value, best):
    return (math.isfinite(value) and math.isfinite(best)
            and best - value <= 1e-6 * max(abs(value), 1.0))


def _loss(raw, x, y, mask, spec, gram):
    with torch.no_grad():
        return float(neg_mll(raw, x, y, mask, spec, gram))


def _grads(params, loss):
    for p in params.values():
        p.grad = None
    loss.backward()
    for p in params.values():
        p.grad = torch.zeros_like(p) if p.grad is None else torch.nan_to_num(p.grad)


def fit_adam(raw0, x, y, mask, spec, gram=None):
    """Adam (lr fit_lr) with best-iterate tracking and a stop after 10
    steps without a 1e-6 relative gain (SOBER/_gp.py:128-155)."""
    params = {k: v.detach().clone().requires_grad_(True) for k, v in raw0.items()}
    opt = torch.optim.Adam(list(params.values()), lr=spec.fit_lr)
    best_loss, best, n_plateau = math.inf, _detach(raw0), 0
    for _ in range(spec.fit_iters):
        loss = neg_mll(params, x, y, mask, spec, gram)
        value = float(loss)
        _grads(params, loss)
        improved = math.isfinite(value) and value < best_loss
        if improved:
            best = _detach(params)
        n_plateau = n_plateau + 1 if _plateau(value, best_loss) else 0
        if improved:
            best_loss = value
        opt.step()
        if n_plateau >= 10:
            break
    final = _detach(params)
    final_loss = _loss(final, x, y, mask, spec, gram)
    if math.isfinite(final_loss) and final_loss <= _loss(best, x, y, mask, spec, gram):
        return final
    return best


def fit_lbfgs(raw0, x, y, mask, spec, gram=None):
    """L-BFGS with a strong-Wolfe line search, one iteration a step (history
    10, at most 9 evaluations), best-iterate tracking and a stop after 2
    steps without gain (SOBER/_gp.py:174-175)."""
    params = {k: v.detach().clone().requires_grad_(True) for k, v in raw0.items()}
    opt = torch.optim.LBFGS(list(params.values()), lr=1, max_iter=1, max_eval=9,
                            history_size=10, line_search_fn="strong_wolfe")

    def closure():
        loss = neg_mll(params, x, y, mask, spec, gram)
        _grads(params, loss)
        return loss

    best_loss, best, n_plateau = math.inf, _detach(raw0), 0
    for _ in range(max(spec.fit_iters // 4, 10)):
        before = _detach(params)
        value = float(opt.step(closure).detach())
        improved = math.isfinite(value) and value < best_loss
        if improved:
            best = before
        n_plateau = n_plateau + 1 if _plateau(value, best_loss) else 0
        if improved:
            best_loss = value
        if n_plateau >= 2:
            break
    final = _detach(params)
    final_loss = _loss(final, x, y, mask, spec, gram)
    if math.isfinite(final_loss) and final_loss <= best_loss:
        return final
    return best


def fit(x_obs, y_obs, spec: FitSpec):
    """The configuration's fit on the observations, in the configuration's
    precision (float32, TF32 off: the caller holds TF32 off): pad to the
    bucket, standardize y over the real rows, then Adam, or L-BFGS falling
    back to Adam when it ends above its start. Its objective is the one the
    configuration states in that precision, whose 1e-2 retry a float32 Gram
    of a campaign's late, clustered observations needs, so a fit in another
    precision optimises another function. Returns (hypers, the padded
    problem (x, y, mask), the Gram without outputscale or None)."""
    x, y_raw, mask = pad(x_obs.to(FIT_DTYPE), y_obs.to(FIT_DTYPE).reshape(-1), spec.bucket)
    mean, sd = masked_stats(y_raw, mask)
    y = (y_raw - mean) / sd * mask
    gram = tanimoto(x, x, None, 1.0) if spec.kernel == "tanimoto" else None
    raw0 = initial_raw(spec, x.device, FIT_DTYPE)
    if spec.optimiser == "adam":
        raw = fit_adam(raw0, x, y, mask, spec, gram)
    else:
        raw = fit_lbfgs(raw0, x, y, mask, spec, gram)
        loss = _loss(raw, x, y, mask, spec, gram)
        if not (math.isfinite(loss) and loss <= _loss(raw0, x, y, mask, spec, gram) + 1e-6):
            raw = fit_adam(raw0, x, y, mask, spec, gram)
    return {k: v.detach() for k, v in hypers(raw, spec).items()}, (x, y, mask), gram


def loss_at(h: dict, problem, spec: FitSpec, gram=None) -> float:
    """The fit's objective at given hypers, in the problem's precision."""
    x, y, mask = problem
    h = {k: torch.as_tensor(v, dtype=x.dtype, device=x.device) for k, v in h.items()}
    return _loss(raw_of(h, spec), x, y, mask, spec, gram)


# ----------------------------------------------------------------------------
# the posterior and pi
# ----------------------------------------------------------------------------

class Posterior:
    """The zero-mean GP posterior on standardized targets, at given hypers,
    in float64 arithmetic (SOBER/_gp.py predict: the variance includes the
    noise), its factor with the jitter of the float32 configuration."""

    def __init__(self, x_obs, y_obs, h: dict, spec: FitSpec):
        dev = x_obs.device
        self.kernel = KERNELS[spec.kernel]
        self.ls = torch.as_tensor(h.get("ls", 1.0), dtype=F64, device=dev)
        self.os = torch.as_tensor(h["os"], dtype=F64, device=dev)
        self.noise = torch.as_tensor(h["noise"], dtype=F64, device=dev)
        x, y_raw, mask = pad(x_obs.to(F64), y_obs.to(F64).reshape(-1), spec.bucket)
        mean, sd = masked_stats(y_raw, mask)
        self.x, self.mask = x, mask
        y = (y_raw - mean) / sd * mask
        k = _masked_gram(self.k(x, x), self.noise, mask)
        # the posterior's factor carries the jitter that float32 needs
        self.chol = _cholesky(k, float32_jitter(0.5 * (k + k.T)))
        self.alpha = torch.cholesky_solve(y[:, None], self.chol)[:, 0]
        mu, _ = self.mean_var(x[mask > 0])
        self.eta = torch.max(mu)

    def k(self, a, b):
        return self.kernel(a.to(F64), b.to(F64), self.ls, self.os)

    def _v(self, xq):
        """L^-1 K(X, xq) with padding columns zeroed: (n, q)."""
        kxq = self.k(self.x, xq) * self.mask[:, None]
        return kxq, torch.linalg.solve_triangular(self.chol, kxq, upper=False)

    def mean_var(self, xq):
        kxq, v = self._v(xq)
        mean = kxq.T @ self.alpha
        var = torch.clamp_min(self.os - torch.sum(v * v, 0), 1e-12) + self.noise
        return mean, var

    def pi(self, xq):
        """Phi((mu - eta) / sigma), in blocks of rows."""
        out = []
        for s in range(0, xq.shape[0], BLOCK):
            mu, var = self.mean_var(xq[s:s + BLOCK])
            out.append(torch.special.ndtr((mu - self.eta) / torch.sqrt(var)))
        return torch.cat(out)

    def covariance(self, xa, xb, weighted: bool):
        """The posterior cross-covariance K(a, b | D) = K(a, b) - K(a,X) K^-1
        K(X, b); `weighted` multiplies by the posterior means on both sides
        (the weighted predictive covariance, SOBER/_kernel.py)."""
        ka, va = self._v(xa)
        kb, vb = self._v(xb)
        cov = self.k(xa, xb) - va.T @ vb
        if weighted:
            cov = (ka.T @ self.alpha)[:, None] * cov * (kb.T @ self.alpha)[None, :]
        return cov


def factors_in_float32(a) -> bool:
    """Whether the matrix, rounded to float32, has a finite float32 Cholesky
    factor."""
    chol, info = torch.linalg.cholesky_ex(a.to(torch.float32))
    return int(info) == 0 and bool(torch.isfinite(torch.diagonal(chol)).all())


def float32_jitter(a) -> float:
    """The diagonal jitter that the configuration's float32 factorization
    adds (SOBER/_utils.py:131-157, with float32's floor): from 1e-6 of the
    mean |diagonal| up by tens while the matrix does not factor in
    float32, at most 10 times."""
    scale = max(float(torch.mean(torch.abs(torch.diagonal(a)))), 1e-30)
    eye = torch.eye(a.shape[0], dtype=a.dtype, device=a.device)
    jitter = 1e-6 * scale
    for _ in range(10):
        if factors_in_float32(a + jitter * eye):
            break
        jitter *= 10.0
    return jitter


def _cholesky(a, jitter: float = 0.0):
    """Cholesky of a symmetric positive definite float64 matrix plus
    `jitter`, with more (from 1e-12 of the mean diagonal up) only where
    float64 needs it."""
    a = 0.5 * (a + a.T)
    scale = torch.mean(torch.abs(torch.diagonal(a)))
    eye = torch.eye(a.shape[0], dtype=a.dtype, device=a.device)
    extra = 0.0
    for _ in range(12):
        chol, info = torch.linalg.cholesky_ex(a + (jitter + extra) * eye)
        if int(info) == 0:
            return chol
        extra = 1e-12 * float(scale) if extra == 0.0 else extra * 10.0
    raise RuntimeError("reference: the Gram is not positive definite")


# ----------------------------------------------------------------------------
# proposals and weights
# ----------------------------------------------------------------------------

def uniform_pdf(x, lo, hi):
    """The Uniform prior's density: 1 / volume strictly inside the box, 0 on
    or outside it (SOBER/_prior.py:67-70)."""
    lo, hi = lo.to(F64), hi.to(F64)
    x = x.to(F64)
    inside = torch.all(x > lo, 1) & torch.all(x < hi, 1)
    return torch.where(inside, 1.0 / torch.prod(hi - lo), 0.0)


def wkde_pdf(centers, weights, covariance, lo, hi, x):
    """A weighted Gaussian mixture with one shared covariance, 0 outside the
    closed box (SOBER/_wkde.py pdf)."""
    centers, weights, x = centers.to(F64), weights.to(F64), x.to(F64)
    chol = _cholesky(covariance.to(F64))
    d = x.shape[1]
    log_norm = torch.sum(torch.log(torch.diagonal(chol))) + 0.5 * d * math.log(2 * math.pi)
    zc = torch.linalg.solve_triangular(chol, centers.T, upper=False).T
    zc2 = torch.sum(zc * zc, 1)
    out = []
    for s in range(0, x.shape[0], 8192):
        z = torch.linalg.solve_triangular(chol, x[s:s + 8192].T, upper=False).T
        d2 = torch.clamp_min(torch.sum(z * z, 1)[:, None] + zc2[None, :] - 2.0 * z @ zc.T, 0.0)
        out.append(torch.exp(-0.5 * d2 - log_norm) @ weights)
    out = torch.cat(out)
    inside = torch.all(x >= lo.to(F64), 1) & torch.all(x <= hi.to(F64), 1)
    return torch.where(inside, out, 0.0)


def row_index(rows, table):
    """For each row of `rows`, the index of the row of `table` equal to it
    bit for bit, or -1 where none is."""
    mult = torch.tensor(0x9E3779B97F4A7C15 - 2**64, dtype=torch.int64, device=table.device)

    def key(a):
        bits = a.contiguous().view(torch.int32).to(torch.int64)
        h = torch.zeros(a.shape[0], dtype=torch.int64, device=a.device)
        for j in range(a.shape[1]):
            h = h * mult + bits[:, j]
        return h

    keys, order = torch.sort(key(table))
    q = key(rows)
    pos = torch.clamp_max(torch.searchsorted(keys, q), keys.numel() - 1)
    idx = order[pos]
    same = torch.all(table[idx] == rows, dim=1)
    return torch.where(same, idx, -1)


def wkde_fit(x_pool, w_pool, centers):
    """The weighted KDE that the configuration fits to a weighted pool
    (SOBER/_wkde.py:53-107), on the components that its draw picked (rows of
    the pool): each component's weight is its row's pool weight, cleansed;
    the bandwidth is Scott's rule on the effective sample size; the shared
    covariance is the components' weighted covariance, debiased, times the
    bandwidth squared, with the jitter that a float32 factorization needs.
    Returns (weights, covariance), or None where a component is not a row of
    the pool."""
    idx = row_index(centers, x_pool)
    if bool((idx < 0).any()):
        return None
    x = centers.to(F64)
    w = cleanse(w_pool.to(F64)[idx])
    d = x.shape[1]
    bw = (1.0 / torch.sum(w * w)) ** (-1.0 / (d + 4))
    resid = x - (w @ x)[None, :]
    cov = (resid.T * w[None, :]) @ resid / torch.clamp_min(1.0 - torch.sum(w * w), 1e-6)
    cov = cov * bw ** 2
    cov = 0.5 * (cov + cov.T)
    eye = torch.eye(d, dtype=F64, device=cov.device)
    return w, cov + float32_jitter(cov) * eye


def pi_tv(p_port, p_ref):
    """The total variation between the two pi's normalized over the rows:
    sum |p_port / sum p_port - p_ref / sum p_ref|, in [0, 2]."""
    a, b = p_port.to(F64), p_ref.to(F64)
    return float(torch.sum(torch.abs(a / torch.clamp_min(torch.sum(a), 1e-300)
                                     - b / torch.clamp_min(torch.sum(b), 1e-300))))


def cleanse(w):
    """Weights below float32's epsilon (negatives included) to 0, then
    normalized; all zero -> uniform (SOBER/_weights.py:21-38)."""
    w = torch.where(w < EPS32, 0.0, w)
    total = torch.sum(w)
    if float(total) <= 0:
        return torch.full_like(w, 1.0 / w.shape[0])
    return w / total


def top_k(values, k: int):
    """Indices of the k largest, ties to the lower index."""
    return torch.sort(values, descending=True, stable=True).indices[:k]


# ----------------------------------------------------------------------------
# recombination's moments
# ----------------------------------------------------------------------------

def moment_gap(cov, x_cand, x_nys, weights, idx, w, n_test: int,
               n_top: int = TOP) -> tuple[float, float]:
    """How far the batch's moments lie from the pool's: the test functions
    are the top n_test eigenvectors of the kernel on the Nystrom points
    (SOBER/_rchq.py), phi = U K(nys, pool); the gap is
    max |phi mu - phi[:, idx] w| / max |phi| with mu the normalized pool
    weights. Returns (the gap over all n_test functions, the gap over the
    n_top of largest eigenvalue). `cov(a, b)` is the recombination kernel.

    The functions of small eigenvalue live where the posterior variance is
    small; with a late campaign's jittered float32 Gram the program's own
    features are undetermined there (PERF.md section 4), while the top
    functions are not."""
    k_nn = cov(x_nys, x_nys)
    k_nn = torch.nan_to_num(0.5 * (k_nn + k_nn.T))
    _, vecs = torch.linalg.eigh(k_nn)                       # ascending
    u = vecs[:, -n_test:].T
    mu = weights.to(F64) / torch.sum(weights.to(F64))
    pool_m = torch.zeros(n_test, dtype=F64, device=u.device)
    scale = torch.zeros(n_test, dtype=F64, device=u.device)
    for s in range(0, x_cand.shape[0], BLOCK):
        phi = u @ cov(x_nys, x_cand[s:s + BLOCK])
        pool_m += phi @ mu[s:s + BLOCK]
        scale = torch.maximum(scale, torch.max(torch.abs(phi), dim=1).values)
    batch_m = (u @ cov(x_nys, x_cand[idx])) @ w.to(F64)
    diff = torch.abs(pool_m - batch_m)
    top = slice(n_test - min(n_top, n_test), n_test)
    return (float(torch.max(diff) / torch.clamp_min(torch.max(scale), 1e-300)),
            float(torch.max(diff[top]) / torch.clamp_min(torch.max(scale[top]), 1e-300)))
