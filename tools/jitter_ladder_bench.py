"""Time two ways up jitter_cholesky's jitter ladder on one CUDA device.

    python3 tools/jitter_ladder_bench.py

`by_rung` is the port's `sober_tpu_torch.utils.linalg.jitter_cholesky`: the
ladder climbed one rung at a time, each rung checked from the host.
`batched` is the alternative kept here for the comparison: the same
prelude, then the first rung factored alone and the other max_tries rungs
as one batched call, the first finite factor picked on the device. Matrices:
a 4 x 4 proposal covariance; GP Grams of 128, 256, 512 and 640 padded rows
(an RBF Gram of points in [0, 10]^4, lengthscale 2, noise 0.01), which
factor at the first rung; ones - 0.001 I at 512 rows, which climbs the
ladder.

For each, median of 30 by host clock: `done_ms`, the call and a device
sync; `return_ms`, the call alone behind a 2 ms sleep kernel (the host
waits for the queue only where it reads). Also the host reads a call makes
(torch.cuda's sync debug mode) and the two factors' largest difference.
One JSON line per matrix, then nvidia-smi's name and power limit.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from sober_tpu_torch.ops.rbf_gram import rbf_gram_reference  # noqa: E402
from sober_tpu_torch.utils import linalg  # noqa: E402

REPS = 30
# SM cycles of the sleep kernel queued ahead of `return_ms`: ~2 ms at 1980 MHz
SLEEP_CYCLES = 4_000_000


def batched(a: torch.Tensor, max_tries: int):
    """jitter_cholesky's prelude and ladder jit0 * 10^k, k = 0..max_tries,
    with the first rung factored alone and the rest as one batch; the first
    finite factor wins, else the diagonal fallback at the last rung."""
    a = linalg.symmetrize(torch.nan_to_num(a))
    n = a.shape[-1]
    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    scale = torch.clamp_min(torch.mean(torch.abs(torch.diagonal(a))), 1e-30)
    jit0 = torch.clamp_min(1e-6 * scale, 0.0)
    tens = torch.full((max_tries + 1,), 10.0, dtype=a.dtype, device=a.device)
    tens[0] = 1.0
    rungs = jit0 * torch.cumprod(tens, 0)
    first, info0 = torch.linalg.cholesky_ex(a + jit0 * eye)
    rest, info = torch.linalg.cholesky_ex(a[None] + rungs[1:, None, None] * eye)
    chol = torch.cat([first[None], rest])
    ok = torch.cat([info0[None], info]) == 0
    ok &= torch.isfinite(chol).flatten(1).all(dim=1)
    k = torch.where(ok.any(), torch.argmax(ok.to(torch.int32)), max_tries).reshape(1)
    diag = torch.diag(torch.sqrt(torch.clamp_min(torch.diagonal(a), 1e-30)))
    return (torch.where(ok.any(), chol.index_select(0, k)[0], diag),
            rungs.index_select(0, k)[0])


def by_rung(a: torch.Tensor, max_tries: int):
    return linalg.jitter_cholesky(a, max_tries=max_tries)


def host_reads(fn) -> int:
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchronizing" in str(w.message) for w in caught)


def timed(fn) -> dict:
    fn()
    torch.cuda.synchronize()
    done, ret = [], []
    for _ in range(REPS):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        done.append(1e3 * (time.perf_counter() - t0))
        torch.cuda._sleep(SLEEP_CYCLES)
        t0 = time.perf_counter()
        fn()
        ret.append(1e3 * (time.perf_counter() - t0))
        torch.cuda.synchronize()
    return {"done_ms": statistics.median(done), "return_ms": statistics.median(ret),
            "host_reads": host_reads(fn)}


def matrices(dev):
    gen = torch.Generator(device="cpu").manual_seed(0)
    params = {"lengthscale": torch.tensor(2.0, device=dev),
              "outputscale": torch.tensor(1.0, device=dev)}
    b = torch.randn((4, 4), generator=gen).to(dev)
    yield "covariance 4", b @ b.T + 0.1 * torch.eye(4, device=dev)
    for n in (128, 256, 512, 640):
        x = (10.0 * torch.rand((n, 4), generator=gen)).to(dev)
        yield f"gp gram {n}", (rbf_gram_reference(params, x, x)
                               + 0.01 * torch.eye(n, device=dev))
    yield "indefinite 512", (torch.ones((512, 512), device=dev)
                             - 1e-3 * torch.eye(512, device=dev))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("jitter_ladder_bench: no CUDA device")
    dev = torch.device("cuda")
    max_tries = linalg.settings().max_psd_iter
    for name, a in matrices(dev):
        (l_b, j_b), (l_r, j_r) = batched(a, max_tries), by_rung(a, max_tries)
        row = {"matrix": name, "n": a.shape[0], "max_tries": max_tries,
               "jitter": [float(j_b), float(j_r)],
               "factor_max_diff": float((l_b - l_r).abs().max()),
               "batched": timed(lambda: batched(a, max_tries)),
               "by_rung": timed(lambda: by_rung(a, max_tries))}
        print(json.dumps(row), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
