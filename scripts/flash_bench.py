"""`flash_attention` on the card: what ptxas reports for each instance of
the kernel, the kernel against its plain version on the checks of
`chip_smoke.py`, and its time a call at the served shapes (zamba2-7b and
granite-3-8b prefill) beside one `scaled_dot_product_attention` call on
the same values.

    python3 scripts/flash_bench.py [--root DIR]

`--root` takes `chip_smoke.py`, the wrapper and the kernel source from
another checkout, so that two versions can be timed in turns on one card.
Needs a CUDA card and nvcc; exits 1 on a failed check.
"""
from __future__ import annotations

import argparse
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

# (label, B, S=T, H, KV, hd) at the served prefill, bf16, causal
SHAPES = [("zamba2-7b", 4, 2048, 32, 32, 112),
          ("granite-3-8b", 4, 2048, 32, 8, 128)]


def ptxas_report(backend) -> list[str]:
    """One line per kernel instance (registers, barriers, stack and
    spills) and one per warning, from `nvcc -Xptxas -v` with the backend's
    own flags."""
    src = backend.CSRC / "flash_attention.cu"
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
            inst = re.search(r"flash_(bf16|f32)_kernelILi(\d+)E", entry[1])
            name = f"{inst[1]}<{inst[2]}>" if inst else entry[1]
        elif "bytes stack frame" in line:
            spill = line.strip()
        elif "Used" in line and name:
            rows.append(f"ptxas {name}: {line.split(':', 1)[1].strip()}; "
                        f"{spill}")
            name = None
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parents[1])
    root = ap.parse_args().root.resolve()
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
    backend.build_kernels(("flash_attention",))
    for row in ptxas_report(backend):
        print(row)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    try:
        _, rows = chip_smoke.check_flash(gen)
    except RuntimeError as e:
        print(f"flash_bench: {e}", file=sys.stderr)
        return 1
    for row in rows:
        print(row)
    for label, b, s, h, kv, hd in SHAPES:
        t = chip_smoke.time_flash(gen, b, s, h, kv, hd)
        print(f"flash_attention {label} (B={b} S=T={s} H={h} KV={kv} "
              f"hd={hd}, bf16, causal): kernel {t['ms'] * 1e3:.2f} us, sdpa "
              f"{t['library_ms'] * 1e3:.2f} us (kernel/sdpa "
              f"{t['ms'] / t['library_ms']:.3f}), plain "
              f"{t['plain_ms'] * 1e3:.2f} us, bound {t['bound_ms'] * 1e3:.2f}"
              f" us ({t['bound_by']}), {t['ops'] / t['ms'] / 1e9:.1f} "
              f"TFLOP/s")
    print("flash_bench: ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
