#!/usr/bin/env python3
"""flash_attention's K/V ring with a late second warpgroup: every wait met.

    python3 scripts/flash_ring_probe.py

Builds `src/repro_torch/kernels/csrc/flash_attention.cu` twice with nvcc, in
parallel: as the port builds it, and with -DFLASH_RING_PROBE. In the probe
build the second warpgroup of every block sleeps 20 us before it reports a
tile done, so the first runs as far ahead as its waits let it, and a wait
for a tile gives up after 2^20 tries and counts itself instead of waiting
on. The bf16 kernel's two warpgroups share a ring of two K/V stages, and
the second to report a tile done loads the tile two places on; a
warpgroup that ran ahead of that order took the other's report as its own
and left a tile unloaded, on which the other waited forever (the kernel's
header). For each case, causal bf16 calls at a served shape, 20 calls of
the probe build must meet every wait (count 0) and give the production
build's output bit for bit. Prints one JSON line a case and, last,
{"ok": ...}; exits 1 where a case fails. Needs one card.
"""
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

CALLS = 20
# (label, B, S, H, KV, hd, dv, window): a rank's heads of granite-3-8b on
# a 1x2 split, llava-next-34b's 2912 positions (the last tile ragged),
# gemma3-4b's local layer, MLA's hd 192 / dv 128, a small ragged case
CASES = [("granite-3-8b per rank", 4, 2048, 16, 4, 128, 128, 0),
         ("llava-next-34b", 4, 2912, 56, 8, 128, 128, 0),
         ("gemma3-4b local", 4, 2048, 8, 4, 256, 256, 1024),
         ("deepseek-v2-lite MLA", 4, 2048, 16, 16, 192, 128, 0),
         ("ragged, GQA 4", 2, 1000, 8, 2, 112, 112, 0)]


def bind(lib: ctypes.CDLL):
    fn = lib.flash_attention
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def call(fn, q, k, v, window: int) -> torch.Tensor:
    B, S, H, hd = q.shape
    T, KV, dv = k.shape[1], k.shape[2], v.shape[-1]
    out = q.new_empty((B, S, H, dv))
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S,
            T, H, KV, hd, dv, 1 | 2, window,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {rc}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_ring_probe: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import backend
    probe_dir = ROOT / "build" / "probe"
    probe_dir.mkdir(parents=True, exist_ok=True)
    probe_so = probe_dir / "libflash_attention_ring_probe.so"
    nvcc = subprocess.Popen(
        [backend._nvcc(), *backend.NVCC_FLAGS, "-DFLASH_RING_PROBE", "-o",
         str(probe_so), str(backend.CSRC / "flash_attention.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    prod_so = backend.build_kernels(("flash_attention",))["flash_attention"]
    log, _ = nvcc.communicate()
    if nvcc.returncode != 0:
        print(log, file=sys.stderr)
        return 1
    prod = bind(ctypes.CDLL(str(prod_so)))
    probe_lib = ctypes.CDLL(str(probe_so))
    probe = bind(probe_lib)
    take = probe_lib.flash_probe_unmet_take
    take.argtypes, take.restype = [ctypes.POINTER(ctypes.c_uint)], \
        ctypes.c_int

    def unmet() -> int:
        n = ctypes.c_uint(0)
        torch.cuda.synchronize()
        if take(ctypes.byref(n)) != 0:
            raise RuntimeError("flash_probe_unmet_take failed")
        return int(n.value)

    gen = torch.Generator(device="cuda").manual_seed(0)
    ok = True
    unmet()
    for label, B, S, H, KV, hd, dv, window in CASES:
        q = torch.randn((B, S, H, hd), generator=gen, device="cuda"
                        ).bfloat16()
        k = torch.randn((B, S, KV, hd), generator=gen, device="cuda"
                        ).bfloat16()
        v = torch.randn((B, S, KV, dv), generator=gen, device="cuda"
                        ).bfloat16()
        want = call(prod, q, k, v, window)
        equal = 0
        for _ in range(CALLS):
            equal += bool(torch.equal(call(probe, q, k, v, window), want))
        missed = unmet()
        passed = missed == 0 and equal == CALLS
        ok = ok and passed
        print(json.dumps({"case": label, "shape": [B, S, H, KV, hd, dv],
                          "window": window, "calls": CALLS,
                          "unmet_waits": missed, "bit_equal_calls": equal,
                          "ok": passed}))
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
