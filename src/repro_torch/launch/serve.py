"""Batched serving: prefill a batch of prompts, decode greedily
(counterpart of `repro/launch/serve.py`).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \\
        --smoke --device cpu

On the card (the default device) every prefill attention call runs the
hand-written `flash_attention` kernel and every prefill SSD scan the
`ssd_scan` kernel; decode runs plain PyTorch. Params are random, drawn on
the device from `--seed`, or loaded from a `checkpoint.save_pytree`
snapshot with `--params` (of either package: the file format is shared);
prompts are drawn from the seed. A vision_text model (llava-next-34b)
also takes `n_patches` random patch embeddings a prompt (the stub
frontend's output), drawn from the seed after the prompts; its prefill
covers n_patches + P positions and its cache n_patches + P + T (the
reference's driver sizes it P + T, too short for the patches). An
encoder-only model (hubert-xlarge) has nothing to decode: score it with
`launch.steps.make_encoder_step`.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import load_pytree
from repro_torch.configs import ArchConfig, get_config, get_smoke_config
from repro_torch.kernels import ops
from repro_torch.kernels.backend import (DEFAULT_DEVICE, resolve_device,
                                         set_numerics)
from repro_torch.models import build_model


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def prompt_batch(cfg: ArchConfig, batch: int, prompt_len: int,
                 gen: torch.Generator, device: str | torch.device
                 ) -> tuple[dict, int]:
    """The batch `serve` prefills: `batch` random prompts of `prompt_len`
    tokens drawn from `gen` (a CPU generator) and, for a vision_text
    config, n_patches patch embeddings a prompt (x 0.02, the stub
    frontend's output) drawn after them, all moved to `device`; and the
    positions the prefill covers (n_patches + prompt_len for vision_text,
    else prompt_len), where decode writes first."""
    out = {"tokens": torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                                   generator=gen).to(device)}
    if cfg.modality != "vision_text":
        return out, prompt_len
    out["patches"] = (torch.randn((batch, cfg.n_patches, cfg.d_model),
                                  generator=gen) * 0.02).to(device)
    return out, cfg.n_patches + prompt_len


def serve(arch: str = "mamba2-1.3b", *, smoke: bool = False, batch: int = 4,
          prompt_len: int = 32, new_tokens: int = 16, seed: int = 0,
          device: str | torch.device = DEFAULT_DEVICE,
          cfg: ArchConfig | None = None, params=None) -> dict:
    """Prefill `batch` random prompts of `prompt_len` tokens, then decode
    `new_tokens` greedily. `cfg` overrides `arch`/`smoke` (e.g. a config
    with its depth cut); `params` (a tree of tensors on `device`, e.g. from
    `load_pytree`) replace the random init.

    Returns {"cfg", "n_params", "prompts" (B,P), "patches" (B,n_patches,d)
    or None, "logits" (B,V) of the prefill,
    "tokens" (B,T) generated, "prefill_s", "decode_s" (host clock, each
    ending in a device sync), "launches": {"prefill": ..., "decode": ...}
    (model-kernel launches in each phase)}.
    """
    dev = resolve_device(device)
    if dev.type == "cuda":
        set_numerics()
    if cfg is None:
        cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if not cfg.supports_decode:
        raise ValueError(f"{cfg.name} is encoder-only")
    model = build_model(cfg)
    if params is None:
        params = model.init(seed, device=dev)
    B, P, T = batch, prompt_len, new_tokens
    batch, base = prompt_batch(cfg, B, P, torch.Generator().manual_seed(seed),
                               dev)
    prompts = batch["tokens"]
    cache = model.init_cache(B, base + T, device=dev)
    _sync(dev)
    before = ops.model_kernel_launches()
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, batch, cache)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    after_prefill = ops.model_kernel_launches()

    prefill_logits = logits
    outs = []
    tok = logits.argmax(-1)[:, None]
    t0 = time.perf_counter()
    for i in range(T):
        outs.append(tok)
        logits, cache = model.decode_step(params, tok, base + i, cache)
        tok = logits.argmax(-1)[:, None]
    _sync(dev)
    t_decode = time.perf_counter() - t0
    after_decode = ops.model_kernel_launches()
    return {
        "cfg": cfg, "n_params": model.param_count(params),
        "prompts": prompts, "patches": batch.get("patches"),
        "logits": prefill_logits,
        "tokens": torch.cat(outs, dim=1) if outs else prompts[:, :0],
        "prefill_s": t_prefill, "decode_s": t_decode,
        "launches": {
            "prefill": {k: after_prefill[k] - before[k] for k in before},
            "decode": {k: after_decode[k] - after_prefill[k]
                       for k in before}}}


def report(out: dict) -> list[str]:
    """The lines `main` prints for a `serve` result. tok/s counts text
    tokens, as the reference's driver does: a vision_text prefill also
    covers its patches (named on the first line)."""
    cfg = out["cfg"]
    (B, P), T = out["prompts"].shape, out["tokens"].shape[1]
    tp, td = out["prefill_s"], out["decode_s"]
    patches = ("" if out["patches"] is None
               else f" patches={out['patches'].shape[1]}")
    lines = [f"arch={cfg.name} layers={cfg.n_layers} params="
             f"{out['n_params']} batch={B}{patches} prompt={P} new={T}",
             f"prefill: {tp * 1e3:.1f} ms ({B * P / max(tp, 1e-9):.0f} "
             f"tok/s), kernel launches {out['launches']['prefill']}",
             f"decode : {td * 1e3:.1f} ms ({B * T / max(td, 1e-9):.0f} "
             f"tok/s), kernel launches {out['launches']['decode']}"]
    for b in range(min(B, 2)):
        lines.append(f"  sample[{b}] -> {out['tokens'][b, :12].tolist()}")
    return lines


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-1.3b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--params", default=None,
                    help="params snapshot (save_pytree npz) to serve")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args(argv)
    params = (load_pytree(args.params, device=args.device) if args.params
              else None)
    out = serve(args.arch, smoke=args.smoke, batch=args.batch,
                prompt_len=args.prompt_len, new_tokens=args.new_tokens,
                seed=args.seed, device=args.device, params=params)
    print("\n".join(report(out)))
    return out


if __name__ == "__main__":
    main()
