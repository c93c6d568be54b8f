"""Time the RBF Gram kernel at the continuous iteration's strip shapes, on
one CUDA device.

    python3 tools/rbf_gram_bench.py [--parent DIR] [--clock]

For each shape, on uniform random operands with a scalar lengthscale: the
Gram of `sober_tpu_torch/csrc/rbf_gram.cu` held to `rbf_gram_reference`,
and its two probes (`sober_rbf_gram_probe`: the outputs computed but not
written, or written without the distances and the exp), which split its
time between the arithmetic and the stores. The probes are compiled only
here, from the same source with SOBER_RBF_GRAM_PROBES defined, into a
library of their own; the port's library has none. With --parent, the Gram of another checkout of the repository (built from that
checkout's own csrc) on the same inputs, e.g. the parent commit's; the
plain reference; and `torch.empty((n, m)).fill_(1.0)`, a yardstick of the
card's write rate. Every variant is timed twice, in the
order given and then reversed, by CUDA events with a sleep kernel queued
ahead (`chip_smoke.cuda_ms`), median of 20. ptxas's report for the RBF
kernels comes first. One JSON line per shape. With --clock, a last line
holds the SM clock and the power draw that nvidia-smi samples every 50 ms
while the Gram at 512 x 65,536, d = 100 runs back to back for ~2 s.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import FP32_PEAK, bound_ms, cuda_ms  # noqa: E402
from sober_tpu_torch.ops import _build  # noqa: E402
from sober_tpu_torch.ops.rbf_gram import rbf_gram_reference  # noqa: E402

# (n, m, d): the strips of the 65k/200 and 200k/100 iterations, a small
# Gram of both, and a width past the first port's limit of 64
SHAPES = ((512, 65_536, 10), (65_536, 500, 10), (500, 65_536, 10),
          (200_000, 500, 4), (500, 200_000, 4), (500, 500, 10),
          (512, 65_536, 100))
# sober_rbf_gram_probe's probe argument
PROBES = {"no_store": 1, "no_compute": 2}


def parent_library(path: Path):
    """The kernel library of another checkout, built by its own _build."""
    spec = importlib.util.spec_from_file_location(
        "parent_build", path / "sober_tpu_torch" / "ops" / "_build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.load_library()


def probe_function():
    """sober_rbf_gram_probe, from csrc/rbf_gram.cu built with
    SOBER_RBF_GRAM_PROBES defined into a library beside the port's."""
    src = _build.SOURCE_DIR / "rbf_gram.cu"
    flags = (*_build.NVCC_FLAGS, "-DSOBER_RBF_GRAM_PROBES")
    tag = hashlib.sha256(" ".join(flags).encode() + src.read_bytes()).hexdigest()[:16]
    so = _build.BUILD_DIR / f"librbf_gram_probes_{tag}.so"
    if not so.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.tmp")
        subprocess.run([_build._find_nvcc(), *flags, "-shared", "-o", str(tmp), str(src)],
                       check=True, capture_output=True)
        tmp.replace(so)
    fn = ctypes.CDLL(str(so)).sober_rbf_gram_probe
    fn.argtypes = _build._SIGNATURES["sober_rbf_gram"][:-1] + (ctypes.c_int, ctypes.c_void_p)
    fn.restype = ctypes.c_int
    return fn


def gram_call(fn, x, y, ls, os_, out, *extra):
    """A launch of fn on the current stream. A library whose entry point
    takes no ls_stride (the first port's) gets ls as a (d,) vector."""
    n, d = x.shape
    if len(fn.argtypes) == 9:
        ls, extra = ls.reshape(-1).expand(d).contiguous(), ()
    else:
        extra = (int(ls.numel() == d),) + extra

    def run():
        rc = fn(x.data_ptr(), y.data_ptr(), ls.data_ptr(), os_.data_ptr(),
                out.data_ptr(), n, y.shape[0], d, *extra,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"launch failed with CUDA error {rc}")
    return run


def sustained_clock(run) -> dict:
    """nvidia-smi's SM clock (MHz) and power draw (W), sampled every 50 ms
    while run() is launched back to back for ~2 s."""
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "50"],
        stdout=subprocess.PIPE, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < 2.0:
            for _ in range(100):
                run()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
    samples = [line.split(",") for line in smi.communicate()[0].splitlines() if "," in line]
    return {"clocks_sm_mhz": [float(c) for c, _ in samples],
            "power_draw_w": [float(w) for _, w in samples]}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--clock", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("rbf_gram_bench: needs a CUDA device")
    lib = _build.load_library()
    log = _build.library_path().with_suffix(".log").read_text()
    lines = log.splitlines()
    print("\n".join(lines[k + 1] + " " + lines[k + 2] for k, line in enumerate(lines)
                    if "Compiling entry" in line and "rbf_gram" in line), flush=True)
    probe_fn = probe_function()
    calls = {"gram": (lib.sober_rbf_gram, ())}
    calls.update({name: (probe_fn, (probe,)) for name, probe in PROBES.items()})
    if args.parent is not None:
        calls["parent"] = (parent_library(args.parent).sober_rbf_gram, ())
    gen = torch.Generator(device="cuda").manual_seed(0)
    for n, m, d in SHAPES:
        x = torch.rand((n, d), generator=gen, device="cuda") * 2 - 1
        y = torch.rand((m, d), generator=gen, device="cuda") * 2 - 1
        params = {"lengthscale": torch.tensor(0.8, device="cuda"),
                  "outputscale": torch.tensor(1.3, device="cuda")}
        want = rbf_gram_reference(params, x, y)
        row = {"shape": [n, m, d]}
        runs = {}
        for name, (fn, extra) in calls.items():
            if name == "parent" and len(fn.argtypes) == 9 and d > 64:
                continue           # the first port took at most 64 features
            out = torch.full((n, m), float("nan"), device="cuda")
            runs[name] = gram_call(fn, x, y, params["lengthscale"],
                                   params["outputscale"], out, *extra)
            runs[name]()
            torch.cuda.synchronize()
            if "no_" not in name:
                row[f"{name}_max_abs_err"] = float((out - want).abs().max())
        for name in list(runs) + list(reversed(runs)):
            row.setdefault(f"{name}_ms", []).append(cuda_ms(runs[name], reps=20))
        row["plain_ms"] = cuda_ms(lambda: rbf_gram_reference(params, x, y), reps=20)
        row["store_library_ms"] = cuda_ms(
            lambda: torch.empty((n, m), device="cuda").fill_(1.0), reps=20)
        row["bound_ms"], row["bound_by"] = bound_ms(
            4.0 * ((n + m) * d + n * m), float(n) * m * (3 * d + 2), FP32_PEAK)
        print(json.dumps(row), flush=True)
        if args.clock and (n, m, d) == (512, 65_536, 100):
            clock = sustained_clock(runs["gram"])
    if args.clock:
        print(json.dumps(clock), flush=True)


if __name__ == "__main__":
    main()
