"""One kernel on the card: what ptxas reports for each instance of its
source, how many tensor-core instructions each instance's SASS holds (for
the tensor-core kernels), the kernel against its plain version on the
checks of `chip_smoke.py`, and its time beside its bound.

    python3 scripts/flash_bench.py
        [--kernel flash_attention|ssd_scan|mifa_aggregate|paged_bank_gather
                  |bank_scatter|paged_bank_scatter
                  |bank_scatter_batched|paged_bank_scatter_batched]
        [--root DIR]

`flash_attention` (the default) is timed at zamba2-7b's, granite-3-8b's,
gemma3-4b's (its global layers and its local ones, window 1024) and
deepseek-v2-lite-16b's prefill (MLA: q/k head dim 192, v's 128; skipped
for a `--root` whose `time_flash` takes no v head dim) and llava-next-34b's
(2880 patches + 32 tokens: S = 2912, GQA 56 over 8 heads; held against the
plain version there first, bf16 and f32, where the checkout has those
cases) beside one `scaled_dot_product_attention` call on the same values;
`ssd_scan` at zamba2-7b's and mamba2-1.3b's prefill beside its plain
version. `mifa_aggregate`, `paged_bank_gather`, `bank_scatter` and
`paged_bank_scatter` are checked by `chip_smoke.check_mifa` /
`check_paged` / `check_bank` (one leaf at a time) and timed per round of
the paper path (paper_mlp's six leaves, N=100, the main path's typical
mask) through `chip_smoke.time_mifa` / `time_paged_gather` / `time_bank` /
`time_paged_scatter`, beside the per-leaf plain versions, the bound and,
for the gather, `index_select`.
`bank_scatter_batched` and `paged_bank_scatter_batched` are checked by
`chip_smoke.check_batched` (one leaf at a time and on trees) and timed per
round of the cohort fleet path (paper_mlp's six leaves, K=3 trials of a
typical round's cohorts) through `chip_smoke.time_batched`.
`--root` takes `chip_smoke.py`, the wrapper and the kernel source from
another checkout, so that two versions can be timed in turns on one card.
Needs a CUDA card and nvcc; exits 1 on a failed check.
"""
from __future__ import annotations

import argparse
import inspect
import re
import subprocess
import sys
import tempfile
from collections import Counter
from functools import partial
from pathlib import Path

import torch

# (label, B, S=T, H, KV, hd, window, dv) at the served prefill, bf16,
# causal; dv is v's head dim
FLASH_SHAPES = [("zamba2-7b", 4, 2048, 32, 32, 112, 0, 112),
                ("granite-3-8b", 4, 2048, 32, 8, 128, 0, 128),
                ("gemma3-4b global", 4, 2048, 8, 4, 256, 0, 256),
                ("gemma3-4b local", 4, 2048, 8, 4, 256, 1024, 256),
                ("deepseek-v2-lite-16b MLA", 4, 2048, 16, 16, 192, 0, 128),
                ("llava-next-34b, g=7", 4, 2912, 56, 8, 128, 0, 128)]
# (label, b, S, h, p, n, Q) at the served prefill, bf16
SSD_SHAPES = [("zamba2-7b", 4, 2048, 112, 64, 64, 256),
              ("mamba2-1.3b", 4, 2048, 64, 64, 128, 256)]
# a kernel instance's mangled name -> "dtype<template args>"
INSTANCE = re.compile(r"(?:flash|ssd_scan)_(bf16|f32)_kernelI((?:L[ib]\d+E)+)")
# any other kernel: its name and, where it is a template, the mangled
# arguments
OTHER = re.compile(r"([a-z_]+_kernel)(I\w*?EE)?")
TC_OPS = ("HMMA", "HGMMA")
# --kernel -> the source (library) that holds it
SOURCE = {"flash_attention": "flash_attention", "ssd_scan": "ssd_scan",
          "mifa_aggregate": "mifa_aggregate",
          "paged_bank_gather": "paged_bank",
          "bank_scatter": "bank_scatter", "paged_bank_scatter": "paged_bank",
          "bank_scatter_batched": "bank_scatter",
          "paged_bank_scatter_batched": "paged_bank"}


def instance_name(mangled: str) -> str:
    inst = INSTANCE.search(mangled)
    if not inst:
        other = OTHER.search(mangled)
        return other[1] + (other[2] or "") if other else mangled
    args = ",".join(re.findall(r"L[ib](\d+)E", inst[2]))
    return f"{inst[1]}<{args}>"


def ptxas_report(backend, kernel: str) -> list[str]:
    """One line per kernel instance (registers, barriers, stack and
    spills) and one per warning, from `nvcc -Xptxas -v` with the backend's
    own flags."""
    src = backend.CSRC / f"{kernel}.cu"
    with tempfile.TemporaryDirectory(dir=backend.BUILD_DIR) as tmp:
        proc = subprocess.run(
            [backend._nvcc(), *backend.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(Path(tmp) / "lib.so"), str(src)],
            capture_output=True, text=True, check=True)
    rows, name, spill = [], None, ""
    for line in (proc.stdout + proc.stderr).splitlines():
        if "warning" in line.lower():
            rows.append(f"ptxas {line.strip()}")
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            name = instance_name(entry[1])
        elif "bytes stack frame" in line:
            spill = line.strip()
        elif "Used" in line and name:
            rows.append(f"ptxas {name}: {line.split(':', 1)[1].strip()}; "
                        f"{spill}")
            name = None
    return rows


def sass_report(backend, kernel: str, lib: Path) -> list[str]:
    """Tensor-core instructions (HMMA: mma.sync; HGMMA: wgmma) in each
    instance's SASS, from `cuobjdump -sass` of the built library."""
    cuobjdump = Path(backend._nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                         capture_output=True, text=True, check=True).stdout
    counts: dict[str, Counter] = {}
    name = None
    for line in out.splitlines():
        fn = re.search(r"Function : (\S+)", line)
        if fn:
            name = instance_name(fn[1])
            counts[name] = Counter()
        elif name:
            op = re.search(r"\b(HGMMA|HMMA)\.", line)
            if op:
                counts[name][op[1]] += 1
    return [f"sass {kernel} {n}: " + ", ".join(f"{c[op]} {op}"
                                               for op in TC_OPS)
            for n, c in sorted(counts.items())]


def bench_flash(chip_smoke, gen) -> list[str]:
    _, rows = chip_smoke.check_flash(gen)
    if hasattr(chip_smoke, "LLAVA_SHAPE"):
        rows += chip_smoke.check_flash_cases(gen, [
            (chip_smoke.LLAVA_SHAPE, dt, True, 0, f"llava path {dt}")
            for dt in (torch.bfloat16, torch.float32)])[1]
    takes_dv = "dv" in inspect.signature(chip_smoke.time_flash).parameters
    for label, b, s, h, kv, hd, window, dv in FLASH_SHAPES:
        if dv != hd and not takes_dv:
            continue
        t = chip_smoke.time_flash(gen, b, s, h, kv, hd, window,
                                  **({"dv": dv} if dv != hd else {}))
        rows.append(
            f"flash_attention {label} (B={b} S=T={s} H={h} KV={kv} hd={hd},"
            f" dv={dv}, bf16, causal, window {window}): kernel "
            f"{t['ms'] * 1e3:.2f} "
            f"us, sdpa {t['library_ms'] * 1e3:.2f} us "
            f"[{t['library_backend']}] (kernel/sdpa "
            f"{t['ms'] / t['library_ms']:.3f}), plain "
            f"{t['plain_ms'] * 1e3:.2f} us, bound {t['bound_ms'] * 1e3:.2f}"
            f" us ({t['bound_by']}), {t['ops'] / t['ms'] / 1e9:.1f} TFLOP/s")
    return rows


def bench_ssd(chip_smoke, gen) -> list[str]:
    _, rows = chip_smoke.check_ssd(gen)
    for label, b, s, h, p, n, q in SSD_SHAPES:
        t = chip_smoke.time_ssd(gen, b, s, h, p, n, q)
        rows.append(
            f"ssd_scan {label} (b={b} S={s} h={h} p={p} n={n} Q={q}, bf16):"
            f" kernel {t['ms'] * 1e3:.2f} us, plain {t['plain_ms'] * 1e3:.2f}"
            f" us, bound {t['bound_ms'] * 1e3:.2f} us ({t['bound_by']}), "
            f"{t['ops'] / t['ms'] / 1e9:.1f} TFLOP/s, "
            f"{t['bytes'] / t['ms'] / 1e6:.1f} GB/s")
    return rows


def path_mask(chip_smoke) -> torch.Tensor:
    """The paper path's typical round, as `chip_smoke.main` picks it: the
    median-|A| mask among rounds 1-21 of the main path's participation."""
    from repro_torch.core import BernoulliParticipation
    part = BernoulliParticipation(chip_smoke.paper_problem(device="cuda")[2],
                                  seed=1)
    masks = [part.sample(t) for t in range(22)][1:]
    return torch.from_numpy(
        sorted(masks, key=lambda m: m.sum())[len(masks) // 2]).cuda()


def bench_round(name, check, time_fn, chip_smoke, gen) -> list[str]:
    """A kernel of the paper path: its checks, then its time per round of
    paper_mlp's six leaves and per launch at each leaf's width."""
    active = path_mask(chip_smoke)
    rows = check(gen, active)[-1]
    t = time_fn(gen, active)
    return rows + round_rows(name, t, f"|A|={int(active.sum())}")


def round_rows(name, t, shape) -> list[str]:
    """A `chip_smoke.time_path` result: the time per round beside the plain
    version, the library call and the bound, then per launch of each
    leaf."""
    lib = ("" if t["library_ms"] is None
           else f", library {t['library_ms'] * 1e3:.2f} us")
    rows = [f"{name} per round (6 leaves of paper_mlp, {shape}): kernel "
            f"{t['ms'] * 1e3:.2f} us, plain "
            f"{t['plain_ms'] * 1e3:.2f} us{lib}, bound "
            f"{t['bound_ms'] * 1e3:.2f} us ({t['bound_by']}, "
            f"{t['bytes']} bytes), {t['bytes'] / t['ms'] / 1e6:.1f} GB/s"]
    for leaf in t["leaves"]:
        lib = ("" if "library_us" not in leaf
               else f", library {leaf['library_us']:.2f} us")
        rows.append(f"  {name} M={leaf['M']:<6} one leaf: kernel "
                    f"{leaf['us']:.2f} us, plain {leaf['plain_us']:.2f} us"
                    f"{lib}, bound {leaf['bound_us']:.2f} us")
    return rows


def bench_mifa(chip_smoke, gen) -> list[str]:
    return bench_round("mifa_aggregate", chip_smoke.check_mifa,
                       chip_smoke.time_mifa, chip_smoke, gen)


def bench_gather(chip_smoke, gen) -> list[str]:
    return bench_round("paged_bank_gather", chip_smoke.check_paged,
                       chip_smoke.time_paged_gather, chip_smoke, gen)


def bench_scatter(chip_smoke, gen) -> list[str]:
    return bench_round("bank_scatter", chip_smoke.check_bank,
                       chip_smoke.time_bank, chip_smoke, gen)


def bench_paged_scatter(chip_smoke, gen) -> list[str]:
    return bench_round("paged_bank_scatter", chip_smoke.check_paged,
                       chip_smoke.time_paged_scatter, chip_smoke, gen)


def bench_batched(name, chip_smoke, gen) -> list[str]:
    """A fleet scatter: its rows of `check_batched`, then its time per
    round of the cohort fleet path (one call for the six leaves and the
    three trials) and per launch at each leaf's width."""
    rows = [row for row in chip_smoke.check_batched(gen,
                                                    path_mask(chip_smoke))[-1]
            if row.startswith(name + " ")]
    t = chip_smoke.time_batched(
        gen, chip_smoke.paper_problem(device="cuda")[2])
    return rows + round_rows(name, t[name], f"K=3 trials, C={t['cohort']}, "
                                            f"valid {t['valid']}")


BENCHES = {"flash_attention": bench_flash, "ssd_scan": bench_ssd,
           "mifa_aggregate": bench_mifa, "paged_bank_gather": bench_gather,
           "bank_scatter": bench_scatter,
           "paged_bank_scatter": bench_paged_scatter,
           "bank_scatter_batched": partial(bench_batched,
                                           "bank_scatter_batched"),
           "paged_bank_scatter_batched": partial(bench_batched,
                                                 "paged_bank_scatter_batched")}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=sorted(BENCHES),
                    default="flash_attention")
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parents[1])
    args = ap.parse_args()
    root = args.root.resolve()
    if not torch.cuda.is_available():
        print("flash_bench: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path[:0] = [str(root / "src"), str(root)]
    import chip_smoke
    from repro_torch.kernels import backend

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print(f"root {root}")
    src = SOURCE[args.kernel]
    lib = backend.build_kernels((src,))[src]
    rows = ptxas_report(backend, src)
    if args.kernel in ("flash_attention", "ssd_scan"):
        rows += sass_report(backend, src, lib)
    for row in rows:
        print(row)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    try:
        rows = BENCHES[args.kernel](chip_smoke, gen)
    except RuntimeError as e:
        print(f"flash_bench: {e}", file=sys.stderr)
        return 1
    for row in rows:
        print(row)
    print("flash_bench: ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
