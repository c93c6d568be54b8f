"""Time the Tanimoto Gram kernel on packed operands at the screening path's
shapes, on one CUDA device.

    python3 tools/tanimoto_gram_bench.py [--parent DIR]

For each shape, on random fingerprints at 2.5% bit density packed
beforehand: the Gram of `sober_tpu_torch/csrc/tanimoto_gram.cu`, held to
`tanimoto_similarity_reference` bit for bit; with --parent, the Gram of
another checkout of the repository (built from that checkout's own csrc) on
the same words, e.g. the parent commit's; and `torch._int_mm` on int8 0/1
operands, the intersections alone. Times are CUDA events with a sleep
kernel queued ahead (`chip_smoke.cuda_ms`), median of 20. ptxas's report
for the Gram kernels comes first. One JSON line per shape.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import INT8_PEAK, bound_ms, cuda_ms  # noqa: E402
from sober_tpu_torch.ops import _build  # noqa: E402
from sober_tpu_torch.ops.tanimoto_gram import (  # noqa: E402
    pack_bits, tanimoto_similarity_reference)

SHAPES = ((133_303, 512, 2048), (500, 2000, 2048), (1000, 777, 300))


def parent_library(path: Path):
    """The kernel library of another checkout, built by its own _build."""
    spec = importlib.util.spec_from_file_location(
        "parent_build", path / "sober_tpu_torch" / "ops" / "_build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.load_library()


def gram_call(fn, xw, nx, yw, ny, out):
    def run():
        rc = fn(xw.data_ptr(), yw.data_ptr(), nx.data_ptr(), ny.data_ptr(),
                out.data_ptr(), xw.shape[0], yw.shape[0], xw.shape[1],
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"launch failed with CUDA error {rc}")
    return run


def int_mm_ms(x, y) -> float:
    """torch._int_mm on int8 copies of x (n, d) and y (m, d), padded with
    zeros to its multiples of 8."""
    pad = lambda t, r, c: torch.nn.functional.pad(
        t, (0, c - t.shape[1], 0, r - t.shape[0]))
    up = lambda v: -(-v // 8) * 8
    d = up(x.shape[1])
    a = pad(x, max(x.shape[0], 17), d).to(torch.int8)
    b = pad(y, up(y.shape[0]), d).to(torch.int8)
    return cuda_ms(lambda: torch._int_mm(a, b.t()), reps=20)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("tanimoto_gram_bench: needs a CUDA device")
    lib = _build.load_library()
    log = _build.library_path().with_suffix(".log").read_text()
    lines = log.splitlines()
    print("\n".join(lines[k + 1] + " " + lines[k + 2] for k, line in enumerate(lines)
                    if "Compiling entry" in line and "tanimoto_gram" in line), flush=True)
    variants = {"gram": lib.sober_tanimoto_gram}
    if args.parent is not None:
        variants["parent"] = parent_library(args.parent).sober_tanimoto_gram
    gen = torch.Generator(device="cuda").manual_seed(0)
    for n, m, d in SHAPES:
        x = (torch.rand((n, d), generator=gen, device="cuda") < 0.025).float()
        y = (torch.rand((m, d), generator=gen, device="cuda") < 0.025).float()
        x[0] = 0.0
        y[-1] = 0.0
        (xw, nx), (yw, ny) = pack_bits(x), pack_bits(y)
        want = tanimoto_similarity_reference(x, y)
        row = {"shape": [n, m, d]}
        for name, fn in variants.items():
            out = torch.empty((n, m), device="cuda")
            run = gram_call(fn, xw, nx, yw, ny, out)
            run()
            torch.cuda.synchronize()
            row[f"{name}_bits_differ"] = int((out != want).sum())
            row[f"{name}_max_abs_err"] = float((out - want).abs().max())
            row[f"{name}_ms"] = cuda_ms(run, reps=20)
        row["int_mm_ms"] = int_mm_ms(x, y)
        row["plain_ms"] = cuda_ms(lambda: tanimoto_similarity_reference(x, y), reps=20)
        row["bound_ms"], row["bound_by"] = bound_ms(
            (n + m) * (d / 8 + 4) + 4.0 * n * m, 2.0 * n * m * d, INT8_PEAK)
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
